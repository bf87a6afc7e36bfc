"""The dry run's ``cost_calibrated`` (`repro_torch.launch.dryrun.
calibrated_costs`: the per-device pass at two and three repeats of the
layer pattern, extrapolated affinely) against a direct pass at four
repeats, for each family's smoke config: a train step on a fake 2 x 2
mesh (train runs every op prefill does, and the backward and the update
besides).  FLOPs, bytes accessed, collective bytes and calls: exactly.
The peak: eager peak is a maximum over the step, affine in depth only
once the same moment sets it, and at these sizes jamba's moves between
three and four repeats; the estimate reads 0.6 % (deepseek-v2-lite),
1.2 % (phi-3-vision) and 10.2 % (jamba) under the direct peak and the
other three exactly, so it is held below it and within 11 %.
"""

import pytest

from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshSpec

MESH_2X2 = MeshSpec((2, 2), ("data", "model"))
TRAIN = configs.Shape("train_t", 16, 4, "train")
FAMILIES = {"dense": "internlm2-1.8b", "moe": "deepseek-v2-lite-16b",
            "hybrid": "jamba-1.5-large-398b", "rwkv": "rwkv6-3b",
            "encoder": "hubert-xlarge", "vlm": "phi-3-vision-4.2b"}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_calibrated_costs_equal_a_direct_count(family):
    cfg = dryrun._unrolled_variant(
        configs.get_smoke_config(FAMILIES[family]), 4)
    assert cfg.family == family
    cal = dryrun.calibrated_costs(cfg, TRAIN, MESH_2X2)
    direct = dryrun.per_device_costs(cfg, TRAIN, MESH_2X2)
    assert cal["flops"] == direct["cost"]["flops"] > 0
    assert cal["bytes accessed"] == direct["cost"]["bytes accessed"]
    assert cal["collectives"] == direct["collectives"]
    assert cal["collective_counts"] == direct["collective_counts"]
    assert direct["collective_counts"]["total"] > 0
    peak = direct["memory"]["peak_bytes"]
    assert 0.89 * peak <= cal["peak_bytes"] <= peak


def test_calibration_extrapolates_to_the_real_depth():
    """At the real depth of a config the calibration's passes did not
    run, the extrapolation is the direct count: deepseek-v2-lite's
    smoke config (a dense layer, then 5 repeats of its MoE pattern)."""
    cfg = dryrun._unrolled_variant(
        configs.get_smoke_config("deepseek-v2-lite-16b"), 5)
    assert cfg.n_layers == 6
    cal = dryrun.calibrated_costs(cfg, TRAIN, MESH_2X2)
    direct = dryrun.per_device_costs(cfg, TRAIN, MESH_2X2)
    assert cal["flops"] == direct["cost"]["flops"]
    assert cal["collective_counts"] == direct["collective_counts"]
