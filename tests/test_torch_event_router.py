"""The port's HAT event router against the JAX package's.

Gate logits are made from a seed with numpy (float32, quantised to force
ties, or rounded to bfloat16) and handed to both packages.  The JAX
router sorts the event stream and scans it; the port takes its
positions from the `moe_dispatch` op (its plain version on CPU tensors).
Tolerances: the integer fields (`expert_ids`, `buffer_rows`,
`event_slot`, `kept`, `load`) exactly; `weights`, `aux_loss` and
`z_loss` within 1e-6 relative (softmax, logsumexp and sums round in
another order than XLA's).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import event_router as jer
from repro_torch.core import event_router as ter

INT_FIELDS = ("expert_ids", "buffer_rows", "event_slot", "kept", "load")
FLOAT_FIELDS = ("weights", "aux_loss", "z_loss")
REL = 1e-6
jax_route = jax.jit(jer.hat_route, static_argnums=(1, 2),
                    static_argnames=("use_hierarchical_scan",))


def _logits(kind, t, e, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, e)).astype(np.float32)
    if kind == "ties":                 # few distinct values per row
        return (np.round(x * 2) / 2).astype(np.float32)
    if kind == "bfloat16":
        return x.astype(ml_dtypes.bfloat16)
    return x


def _route_both(logits, k, capacity, hier=False):
    j = jax_route(jnp.asarray(logits), k, capacity,
                  use_hierarchical_scan=hier)
    tl = torch.from_numpy(logits.astype(np.float32))
    if logits.dtype == ml_dtypes.bfloat16:
        tl = tl.to(torch.bfloat16)
    return j, ter.hat_route(tl, k, capacity, use_hierarchical_scan=hier)


def _assert_same(j, t):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
        assert getattr(t, f).dtype == (torch.bool if f == "kept"
                                       else torch.int32), f
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=REL,
                                   atol=0, err_msg=f)


@pytest.mark.parametrize("kind", ["random", "ties", "bfloat16"])
@pytest.mark.parametrize("t,e,k,cap", [(200, 64, 6, 1000), (512, 64, 6, 60),
                                       (33, 8, 2, 4), (64, 16, 1, 3)])
@pytest.mark.parametrize("hier", [False, True])
def test_route_matches_jax(kind, t, e, k, cap, hier):
    logits = _logits(kind, t, e, t * e + k)
    j, r = _route_both(logits, k, cap, hier)
    _assert_same(j, r)
    if cap < t * k // e:
        assert not bool(r.kept.all())          # the drops are exercised


def test_ties_are_common_and_broken_by_index():
    """bfloat16 logits tie often; the port breaks ties as lax.top_k does
    (lower expert first), where torch.topk gives no such order."""
    logits = _logits("bfloat16", 200, 64, 3)
    gates = torch.softmax(torch.from_numpy(logits.astype(np.float32)), -1)
    top7 = torch.sort(gates, -1, descending=True).values[:, :7]
    assert int((top7[:, 1:] == top7[:, :-1]).any(-1).sum()) > 10
    vals, idx = ter.top_k_stable(gates, 6)
    jv, ji = jax.lax.top_k(jnp.asarray(gates.numpy()), 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_dispatch_and_combine_match_jax():
    logits = _logits("random", 48, 8, 7)
    x = np.random.default_rng(8).standard_normal((48, 16)).astype(np.float32)
    j, r = _route_both(logits, 2, 10)
    jd = jer.dispatch(jnp.asarray(x), j)
    td = ter.dispatch(torch.from_numpy(x), r)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    out = np.random.default_rng(9).standard_normal(
        tuple(td.shape)).astype(np.float32)
    np.testing.assert_allclose(
        ter.combine(torch.from_numpy(out), r, 48).numpy(),
        np.asarray(jer.combine(jnp.asarray(out), j, 48)), rtol=1e-6,
        atol=1e-6)


# ---- tests/test_event_router.py, mirrored on the port ------------------------


def test_no_drop_combine_is_weighted_identity():
    logits = torch.from_numpy(_logits("random", 32, 8, 0))
    r = ter.hat_route(logits, k=2, capacity=64)
    assert bool(r.kept.all())
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (32, 16)).astype(np.float32))
    y = ter.combine(ter.dispatch(x, r), r, 32)
    assert torch.allclose(y, x, atol=1e-5)


def test_capacity_drops_are_fifo_by_token():
    t = 16
    logits = torch.stack([torch.ones(t) * 5.0, torch.zeros(t)], dim=1)
    r = ter.hat_route(logits, k=1, capacity=4)  # all want expert 0
    assert torch.nonzero(r.kept[:, 0])[:, 0].tolist() == [0, 1, 2, 3]


def test_load_counts():
    r = ter.hat_route(torch.from_numpy(_logits("random", 64, 8, 2)), k=2,
                      capacity=64)
    assert int(r.load.sum()) == 64 * 2
    want = np.bincount(r.expert_ids.reshape(-1).numpy(), minlength=8)
    np.testing.assert_array_equal(r.load.numpy(), want)


def test_buffer_rows_consistent_with_event_slot():
    r = ter.hat_route(torch.from_numpy(_logits("random", 32, 4, 3)), k=2,
                      capacity=8)
    buf, ids = r.buffer_rows.numpy(), r.expert_ids.numpy()
    slots, kept = r.event_slot.numpy(), r.kept.numpy()
    for tkn in range(32):
        for j in range(2):
            if kept[tkn, j]:
                assert buf[ids[tkn, j], slots[tkn, j]] == tkn
    assert (buf >= 0).sum() == kept.sum()


def test_refuses_fewer_experts_than_logits():
    with pytest.raises(ValueError, match="below the gate logits' width"):
        ter.hat_route(torch.zeros(4, 8), k=2, capacity=4, num_experts=6)
