"""Profiling: JAX device traces + XLA cost analysis (SURVEY.md §5).

The reference has no tracing at all; the north star requires knowing kernel
speed-of-light, which cost_analysis provides per compiled executable.
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a profiler trace viewable in TensorBoard/XProf."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def cost_analysis(fn, *args) -> dict:
    """FLOPs / bytes estimates of a jitted function from XLA.

    Returns {} when the backend does not expose cost analysis.
    """
    try:
        lowered = jax.jit(fn).lower(*args)
        compiled = lowered.compile()
        ca = compiled.cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0] if ca else {}
        return dict(ca) if ca else {}
    except Exception:
        return {}


# Published peaks of the cards this engine runs on, keyed by
# jax.Device.device_kind (NVIDIA H100 SXM5 and H100 PCIe data sheets; dense
# rates, no sparsity). "f32" is the CUDA-core rate that f32 matmuls run at
# under the engine's "highest" matmul precision; "tf32", "bf16" and "int8"
# are tensor-core rates. They assume the card's full power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {  # SXM5, 700 W
        "f32": 67e12, "tf32": 495e12, "bf16": 989e12, "int8": 1979e12,
        "hbm_bytes_per_s": 3.35e12,
    },
    "NVIDIA H100 PCIe": {  # 350 W
        "f32": 51e12, "tf32": 378e12, "bf16": 756e12, "int8": 1513e12,
        "hbm_bytes_per_s": 2.0e12,
    },
}


def device_peaks(device_kind: str) -> dict:
    """Peak rates of a card by its device_kind. An unknown kind raises:
    no peak is assumed."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind {device_kind!r}") from None


def speed_of_light_report(fn, *args, flops: str = "f32"):
    """Roofline lower bound for one jitted function on the default device:
    XLA's flop and byte counts over the card's peak `flops` rate ("f32",
    "tf32", "bf16" or "int8") and its memory bandwidth."""
    peaks = device_peaks(jax.devices()[0].device_kind)
    ca = cost_analysis(fn, *args)
    n_flops = float(ca.get("flops", 0.0))
    bytes_accessed = float(ca.get("bytes accessed", 0.0))
    t_compute = n_flops / peaks[flops]
    t_memory = bytes_accessed / peaks["hbm_bytes_per_s"]
    return {
        "flops": n_flops,
        "bytes_accessed": bytes_accessed,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_lower_bound_s": max(t_compute, t_memory),
    }
