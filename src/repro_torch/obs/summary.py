"""Run-log analysis behind ``python -m repro_torch.obs summarize`` (the
port of the JAX package's ``obs/summary.py``; the run logs of both
packages share one format).

Pure host code (stdlib + numpy): reading a run log must work on a
machine with no accelerator stack installed.  Readers ignore unknown
event types and fields (the schema's compatibility rule).
"""
from __future__ import annotations

import numpy as np

from repro_torch.obs.runlog import read_runlog


def _by_event(records):
    out: dict[str, list] = {}
    for r in records:
        out.setdefault(r.get("event", "?"), []).append(r)
    return out


def _sparkline(values, width: int = 48) -> str:
    marks = "▁▂▃▄▅▆▇█"
    v = np.asarray(values, np.float64)
    v = v[np.isfinite(v)]
    if v.size == 0:
        return ""
    if v.size > width:  # bucket means down to the display width
        edges = np.linspace(0, v.size, width + 1).astype(int)
        v = np.array([v[a:b].mean() for a, b in zip(edges[:-1], edges[1:])])
    lo, hi = float(v.min()), float(v.max())
    span = (hi - lo) or 1.0
    return "".join(marks[int((x - lo) / span * (len(marks) - 1))] for x in v)


def summarize_dict(records: list[dict]) -> dict:
    """The machine-readable summary (the ``--json`` artifact)."""
    ev = _by_event(records)
    out: dict = {}
    man = ev.get("manifest", [{}])[0]
    out["manifest"] = {
        k: man.get(k)
        for k in ("schema", "config", "backend", "n_devices", "git_sha")
    }

    steps = sorted(ev.get("step", []), key=lambda r: r["step"])
    out["steps"] = {"n": len(steps)}
    if steps:
        nums = [r["step"] for r in steps]
        out["steps"]["first"] = nums[0]
        out["steps"]["last"] = nums[-1]
        out["steps"]["contiguous"] = nums == list(range(nums[0], nums[-1] + 1))
        dts = [r["dt"] for r in steps if r.get("dt") is not None]
        if dts:
            out["steps"]["dt_p50_ms"] = float(np.percentile(dts, 50)) * 1e3
            out["steps"]["dt_p99_ms"] = float(np.percentile(dts, 99)) * 1e3
        losses = [r["loss"] for r in steps if "loss" in r]
        if losses:
            out["steps"]["loss_first"] = losses[0]
            out["steps"]["loss_last"] = losses[-1]
        nonfin = [
            int(np.sum(r["telemetry"]["param_nonfinite"]))
            for r in steps
            if "telemetry" in r and "param_nonfinite" in r["telemetry"]
        ]
        if nonfin:
            out["steps"]["nonfinite_param_steps"] = int(
                np.count_nonzero(nonfin)
            )
        occ = [
            r["telemetry"]["shard_occupancy"]
            for r in steps
            if "telemetry" in r and "shard_occupancy" in r["telemetry"]
        ]
        if occ:
            mean = np.asarray(occ, np.float64).mean(axis=0)
            out["shard_balance"] = {
                "mean_occupancy": mean.tolist(),
                # max/min per-shard load ratio: 1.0 = perfectly balanced
                "skew": float(mean.max() / max(mean.min(), 1e-12)),
            }

    out["triggers"] = {
        "n": len(ev.get("trigger", [])),
        "fired": sum(1 for r in ev.get("trigger", []) if r.get("fire")),
    }
    out["transitions"] = [
        {"step": r.get("step"), "reason": r.get("reason")}
        for r in ev.get("transition", [])
    ]
    out["checkpoints"] = {
        "saved": [r.get("step") for r in ev.get("checkpoint_save", [])],
        "restored": [r.get("step") for r in ev.get("checkpoint_restore", [])],
    }
    out["faults"] = [r.get("step") for r in ev.get("fault", [])]

    hists = ev.get("latency_hist", [])
    if hists:
        h = hists[-1]
        out["serve_latency"] = {
            k: h.get(k) for k in ("n", "p50", "p99", "label")
        }
        if len(hists) > 1:  # the serve engine writes overall/hit/cold
            out["serve_latency_by_label"] = [
                {k: h.get(k) for k in ("n", "p50", "p99", "label")}
                for h in hists
            ]

    # serve-cache health: per-request hit flags + refresh events
    # (serve/dlrm.py writes both; request events without the flag are the
    # LM engine's and are skipped)
    hits = [r["cache_hit"] for r in ev.get("request", []) if "cache_hit" in r]
    if hits:
        out["serve_cache"] = {
            "n_requests": len(hits),
            "hit_rate": float(np.mean(hits)),
        }
    refreshes = ev.get("cache_refresh", [])
    if refreshes:
        out["cache_refreshes"] = [
            {k: r.get(k) for k in ("reason", "n_slots", "n_features", "churn")}
            for r in refreshes
        ]
    return out


def format_summary(records: list[dict]) -> str:
    """The human-readable report."""
    s = summarize_dict(records)
    ev = _by_event(records)
    lines = []
    man = s["manifest"]
    lines.append(
        f"run: config={man['config']} backend={man['backend']} "
        f"devices={man['n_devices']} sha={man['git_sha']} "
        f"schema=v{man['schema']}"
    )
    st = s["steps"]
    if st["n"]:
        cont = "contiguous" if st.get("contiguous") else "GAPS"
        lines.append(
            f"steps: {st['n']} ({st.get('first')}..{st.get('last')}, {cont})"
        )
        if "dt_p50_ms" in st:
            lines.append(
                f"step time: p50 {st['dt_p50_ms']:.2f} ms   "
                f"p99 {st['dt_p99_ms']:.2f} ms"
            )
        if "loss_first" in st:
            steps = sorted(ev["step"], key=lambda r: r["step"])
            curve = _sparkline([r.get("loss", np.nan) for r in steps])
            lines.append(
                f"loss: {st['loss_first']:.4f} -> {st['loss_last']:.4f}  "
                f"{curve}"
            )
        if st.get("nonfinite_param_steps"):
            lines.append(
                f"!! nonfinite params on {st['nonfinite_param_steps']} steps"
            )
    else:
        lines.append("steps: 0")
    if "shard_balance" in s:
        occ = ", ".join(f"{x:.3f}" for x in s["shard_balance"]["mean_occupancy"])
        lines.append(
            f"shard balance: occupancy [{occ}]  "
            f"skew {s['shard_balance']['skew']:.2f}x"
        )
    tr = s["triggers"]
    if tr["n"]:
        lines.append(f"trigger: {tr['n']} evaluations, {tr['fired']} fired")
        for r in ev.get("trigger", []):
            mark = f"FIRED ({r.get('reason')})" if r.get("fire") else "held"
            lines.append(
                f"  step {r.get('step', '?'):>5}  "
                f"entropy {r.get('entropy', float('nan')):6.3f}  "
                f"drift {r.get('drift', float('nan')):5.3f}  {mark}"
            )
    for t in s["transitions"]:
        lines.append(f"transition: step {t['step']} ({t['reason']})")
    ck = s["checkpoints"]
    if ck["saved"] or ck["restored"]:
        lines.append(
            f"checkpoints: saved at {ck['saved']}; restored at {ck['restored']}"
        )
    for f in s["faults"]:
        lines.append(f"fault injected: step {f}")
    for sl in s.get("serve_latency_by_label", [s["serve_latency"]]
                    if "serve_latency" in s else []):
        lines.append(
            f"serve latency ({sl.get('label') or 'requests'}): n={sl['n']}  "
            f"p50 {sl['p50'] * 1e3:.2f} ms  p99 {sl['p99'] * 1e3:.2f} ms"
        )
    if "serve_cache" in s:
        sc = s["serve_cache"]
        lines.append(
            f"serve cache: {sc['n_requests']} requests, "
            f"hit rate {sc['hit_rate']:.1%}"
        )
    for r in s.get("cache_refreshes", []):
        churn = r.get("churn")
        extra = f"  churn {churn:.2f}" if churn is not None else ""
        lines.append(
            f"cache refresh ({r.get('reason')}): {r.get('n_slots')} slots / "
            f"{r.get('n_features')} features{extra}"
        )
    return "\n".join(lines)


def summarize_path(path) -> tuple[str, dict]:
    records = read_runlog(path)
    return format_summary(records), summarize_dict(records)
