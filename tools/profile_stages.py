"""Per-stage device time of the fused steady-state tracking step, from a
profiler trace.

Builds the benchmark's step (__graft_entry__._build_bench_state: 640x480,
512 features, 1024 landmarks, 4096-slot local map), warms it up, traces
`--steps` calls, and attributes each device operation's time to the named
scope it was traced under (frontend/orb.py and slam/tracking.py name every
stage: orb_pyramid, orb_L<l>_{fast_nms,select,angle,blur,brief},
match_motion, pose_motion, match_local, pose_local). XLA names each kernel
after its fusion; the fusion's op_name metadata in the compiled HLO carries
the scope. A fusion that spans two scopes is charged to its root's scope.

XLA:GPU runs most of the step as CUDA graphs; a kernel inside one carries
hlo_op "command_buffer" and its own name, which is then looked up instead.
To see the step without graphs (more launch gaps, same kernels):

    XLA_FLAGS=--xla_gpu_enable_command_buffer= python tools/profile_stages.py

Prints one JSON object (per-stage ms per step and share of the step's
device time, device busy share of the traced window) and writes it, with
the raw device-line names of the trace, to chiprun_out/profile_stages.json;
the trace and the step's compiled HLO go to chiprun_out/stage_trace/.

Usage: python tools/profile_stages.py [--steps 20]
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SCOPE = re.compile(
    r"(orb_pyramid|orb_L\d+_(?:fast_nms|select|angle|blur|brief)"
    r"|match_motion|pose_motion|match_local|pose_local)"
)
INSTR = re.compile(r'^\s*(?:ROOT )?%?([\w.\-]+) = .*?op_name="([^"]*)"')


def scope_of_ops(hlo_text: str) -> dict:
    """HLO instruction name -> stage scope (or 'other')."""
    out = {}
    for line in hlo_text.splitlines():
        m = INSTR.match(line)
        if m:
            s = SCOPE.search(m.group(2))
            out[m.group(1)] = s.group(1) if s else "other"
    return out


def _lookup(scopes: dict, stats: dict, name: str) -> str | None:
    """Scope of one device event: from its traced name stack when the
    profiler recorded one, else from the HLO op it ran."""
    m = SCOPE.search(str(stats.get("name", "")))
    if m:
        return m.group(1)
    op = str(stats.get("hlo_op") or name)
    if op == "command_buffer":
        op = name
    for cand in (op, op.split(":")[0], re.sub(r"_(\d+)$", r".\1", op)):
        if cand in scopes:
            return scopes[cand]
    return None


def reduce_trace(pd, scopes: dict) -> dict:
    """Device time per scope and the device busy share of the window, from
    a jax.profiler.ProfileData."""
    per_scope, unattributed, other = (collections.Counter() for _ in range(3))
    intervals, lines_seen, samples = [], set(), {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            lines_seen.add(line.name)
            if line.name in ("XLA Modules", "XLA Ops", "Steps", "Source code"):
                continue  # derived lines repeat the stream's kernels
            for ev in line.events:
                stats = {k: v for k, v in ev.stats}
                if len(samples) < 12 and ev.name not in samples:
                    samples[ev.name] = {k: str(v)[:120] for k, v in stats.items()}
                scope = _lookup(scopes, stats, ev.name)
                if scope is None:
                    scope = "unattributed"
                    unattributed[ev.name] += ev.duration_ns
                elif scope == "other":
                    other[ev.name] += ev.duration_ns
                per_scope[scope] += ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = (max(b for _, b in intervals) - min(a for a, _ in intervals)) if intervals else 0.0
    return {
        "per_scope_ns": dict(per_scope),
        "busy_ns": busy,
        "window_ns": window,
        "device_lines": sorted(lines_seen),
        "top_unattributed_ns": dict(unattributed.most_common(10)),
        "top_other_ns": dict(other.most_common(10)),
        "sample_events": samples,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--tag", default="", help="suffix of the output file name")
    args = ap.parse_args()

    from orbslam_in_practice.utils import runtime

    runtime.setup()
    import jax

    # compile afresh: the persistent cache's key ignores op metadata, so a
    # cached executable can carry the name stacks of an older build
    jax.config.update("jax_enable_compilation_cache", False)

    from __graft_entry__ import _build_bench_state

    fn, fargs, _ = _build_bench_state(1)
    compiled = fn.lower(*fargs).compile()
    hlo = compiled.as_text()
    scopes = scope_of_ops(hlo)
    for _ in range(3):
        jax.block_until_ready(compiled(*fargs))
    t0 = time.perf_counter()
    for _ in range(args.steps):
        jax.block_until_ready(compiled(*fargs))
    step_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    out_dir = runtime.REPO_ROOT / "chiprun_out"
    log_dir = out_dir / f"stage_trace{args.tag}"
    shutil.rmtree(log_dir, ignore_errors=True)
    log_dir.mkdir(parents=True)
    (log_dir / "fused_step.hlo.txt").write_text(hlo)
    with jax.profiler.trace(str(log_dir)):
        for _ in range(args.steps):
            jax.block_until_ready(compiled(*fargs))
    path = glob.glob(str(log_dir / "**" / "*.xplane.pb"), recursive=True)[0]
    red = reduce_trace(jax.profiler.ProfileData.from_file(path), scopes)
    total = sum(red["per_scope_ns"].values())
    stages = {
        k: {"ms_per_step": v / 1e6 / args.steps, "share": v / total if total else 0.0}
        for k, v in sorted(red["per_scope_ns"].items(), key=lambda kv: -kv[1])
    }

    def share(pattern):
        return sum(s["share"] for k, s in stages.items() if re.fullmatch(pattern, k))

    dev = jax.devices()[0]
    result = {
        "device": {"platform": dev.platform, "kind": dev.device_kind},
        "steps": args.steps,
        "step_ms_wall_untraced": step_ms,
        "device_ms_per_step": total / 1e6 / args.steps,
        "device_busy_share": red["busy_ns"] / red["window_ns"] if red["window_ns"] else 0.0,
        "share_fast_nms": share(r"orb_L\d+_fast_nms"),
        "share_angle_blur_brief": share(r"orb_L\d+_(angle|blur|brief)"),
        "share_extractor": share(r"orb_.*"),
        "stages": stages,
        "device_lines": red["device_lines"],
        "top_unattributed_ns": red["top_unattributed_ns"],
        "top_other_ns": red["top_other_ns"],
        "sample_events": red["sample_events"],
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }
    print(json.dumps(result, indent=1))
    with open(out_dir / f"profile_stages{args.tag}.json", "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
