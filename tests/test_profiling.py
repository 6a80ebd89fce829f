"""Roofline peaks are chosen by device kind, none is assumed; and the
trace reduction of tools/profile_stages.py attributes device time to the
step's named stages."""

import os
import sys

import pytest

from orbslam_in_practice.utils.profiling import device_peaks


@pytest.mark.parametrize(
    "kind, bf16, f32, hbm",
    [
        ("NVIDIA H100 80GB HBM3", 989e12, 67e12, 3.35e12),
        ("NVIDIA H100 PCIe", 756e12, 51e12, 2.0e12),
    ],
)
def test_h100_peaks(kind, bf16, f32, hbm):
    peaks = device_peaks(kind)
    assert peaks["bf16"] == bf16
    assert peaks["f32"] == f32
    assert peaks["hbm_bytes_per_s"] == hbm
    assert peaks["int8"] > peaks["bf16"] > peaks["tf32"] > peaks["f32"]


@pytest.mark.parametrize("kind", ["NVIDIA A100-SXM4-80GB", "cpu", ""])
def test_unknown_kind_raises(kind):
    with pytest.raises(KeyError):
        device_peaks(kind)


HLO = """
  %loop_fusion.3 = f32[4]{0} fusion(%p), kind=kLoop, calls=%fc, metadata={op_name="jit(step)/orb_L0_fast_nms/max"}
  %input_reduce_fusion.7 = f32[] fusion(%q), kind=kInput, calls=%fc2, metadata={op_name="jit(step)/match_local/reduce_sum"}
  ROOT %copy.1 = f32[4]{0} copy(%r), metadata={op_name="jit(step)/concatenate"}
"""

# one GPU stream: a plain kernel, a kernel inside a CUDA graph (hlo_op
# "command_buffer", looked up by its own name), and a library kernel whose
# traced name stack carries the scope, overlapping the previous one
TRACE = """
planes {
  id: 1
  name: "/device:GPU:0"
  lines {
    id: 1
    name: "Stream #13(Compute)"
    timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 2000000 stats { metadata_id: 1 str_value: "loop_fusion.3" } }
    events { metadata_id: 2 offset_ps: 3000000 duration_ps: 1000000 stats { metadata_id: 1 str_value: "command_buffer" } }
    events { metadata_id: 3 offset_ps: 3500000 duration_ps: 1000000 stats { metadata_id: 1 str_value: "custom-call.8" } stats { metadata_id: 2 str_value: "jit(step)/pose_local/solve" } }
    events { metadata_id: 4 offset_ps: 4500000 duration_ps: 500000 stats { metadata_id: 1 str_value: "copy.1" } }
  }
  event_metadata { key: 1 value { id: 1 name: "loop_fusion_3" } }
  event_metadata { key: 2 value { id: 2 name: "input_reduce_fusion_7" } }
  event_metadata { key: 3 value { id: 3 name: "cusolver_kernel" } }
  event_metadata { key: 4 value { id: 4 name: "copy_1" } }
  stat_metadata { key: 1 value { id: 1 name: "hlo_op" } }
  stat_metadata { key: 2 value { id: 2 name: "name" } }
}
"""


def test_trace_reduction_by_stage():
    import jax

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from tools.profile_stages import reduce_trace, scope_of_ops

    scopes = scope_of_ops(HLO)
    assert scopes == {
        "loop_fusion.3": "orb_L0_fast_nms",
        "input_reduce_fusion.7": "match_local",
        "copy.1": "other",
    }
    pd = jax.profiler.ProfileData.from_serialized_xspace(
        jax.profiler.ProfileData.text_proto_to_serialized_xspace(TRACE)
    )
    red = reduce_trace(pd, scopes)
    assert red["per_scope_ns"] == {
        "orb_L0_fast_nms": 2000.0, "match_local": 1000.0,
        "pose_local": 1000.0, "other": 500.0,
    }
    # busy = [1000, 3000] + [4000, 6000] (three overlapping kernels)
    assert red["busy_ns"] == 4000.0
    assert red["window_ns"] == 5000.0
    assert red["device_lines"] == ["Stream #13(Compute)"]
