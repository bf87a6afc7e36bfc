"""`repro_torch.noc`'s public names against the JAX package's.

`dest_core_mask` and `link_loads` on the CAM tables of the JAX
package's `random_connectivity` at `tests/conformance/paths.small_config`
(4 cores x 16 neurons x 32 entries), carried across as numpy, for every
registered NoC scheme: exact (bool masks; link loads are small whole
numbers in float32).  The package exports the JAX package's names.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import fabric
from repro.interface import registry as jregistry
from repro import noc as jnoc
from repro_torch import noc as tnoc
from tests.conformance import paths

SCHEMES = jregistry.NOC_SCHEMES.names()


def _tables(scheme, seed):
    cfg = paths.small_config("hier_tree", scheme)
    p = fabric.random_connectivity(jax.random.PRNGKey(seed), cfg)
    args = (cfg.cores, cfg.neurons_per_core, cfg.tag_bits)
    return cfg, np.asarray(p.tags), np.asarray(p.valid), args


@pytest.mark.parametrize("scheme", SCHEMES)
def test_dest_core_mask_matches_jax(scheme):
    _, tags, valid, args = _tables(scheme, SCHEMES.index(scheme))
    want = np.asarray(jnoc.dest_core_mask(tags, valid, *args))
    got = tnoc.dest_core_mask(torch.from_numpy(tags),
                              torch.from_numpy(valid), *args)
    assert got.dtype == torch.bool and want.dtype == np.bool_
    assert np.array_equal(got.numpy(), want), scheme


@pytest.mark.parametrize("scheme", SCHEMES)
def test_link_loads_matches_jax(scheme):
    cfg, tags, valid, args = _tables(scheme, 10 + SCHEMES.index(scheme))
    dmask = jnoc.dest_core_mask(tags, valid, *args)
    src = np.arange(cfg.cores * cfg.neurons_per_core,
                    dtype=np.int32) // cfg.neurons_per_core
    want = np.asarray(jnoc.link_loads(dmask, src, cfg.cores, scheme))
    got = tnoc.link_loads(torch.from_numpy(np.asarray(dmask)),
                          torch.from_numpy(src), cfg.cores, scheme)
    assert got.shape == want.shape and want.any(), scheme
    assert np.array_equal(got.numpy(), want), scheme


def test_the_package_exports_the_jax_names():
    assert tnoc.__all__ == jnoc.__all__
    assert all(hasattr(tnoc, name) for name in tnoc.__all__)
