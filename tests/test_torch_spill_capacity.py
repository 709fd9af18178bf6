"""The length of the spill list against the JAX package.

The JAX ``spill_patch`` rounds its list up to whole chunks of
``min(16, spill_capacity)`` spills (zanlungo_pallas.py:1477-1479), repairs
every spill the list holds and reports only those past it as unresolved.
The port's ``spill_rows`` sizes its list the same way, so at a capacity
that is not a whole number of chunks (18 here: a list of 32) the two
packages repair the same spills and report the same ``dropped``, on the
spill-patch path and on the fused path (whose storm branch runs the
patch); at 16 and at the 1M bench's 244 (a list of 256) they agreed
before as well.
"""

import numpy as np
import pytest

from rmf_crowdsim_tpu_torch.ops import spill as tspill

from test_torch_fused_spills import jax_fused, overflow_scene, port_fused

TOL = 2e-4
SCENE = dict(seed=7, n_cram=40)     # 19 spills


@pytest.mark.parametrize("cap,want", [(1, 1), (8, 8), (16, 16), (17, 32),
                                      (18, 32), (64, 64), (244, 256)])
def test_list_size_rounds_to_whole_chunks(cap, want):
    assert tspill.spill_list_size(cap) == want


@pytest.mark.parametrize("cap", [18, 16, 244])
@pytest.mark.parametrize("fused", [False, True])
def test_zanlungo_fused_matches_jax_at_capacity(cap, fused):
    scene = overflow_scene(**SCENE)
    kw = dict(spill_capacity=cap, int_prio=True, fused_spills=fused,
              use_pack_kernel=True)
    want, jocc, jdrop = jax_fused(scene, **kw)
    got, tocc, tdrop = port_fused(scene, **kw)
    assert tocc == jocc > 16
    assert tdrop == jdrop
    # 19 spills: only a list of 16 leaves any unresolved.
    assert tdrop == (3 if cap == 16 else 0)
    alive = scene[6]
    np.testing.assert_allclose(got[alive], want[alive], rtol=TOL, atol=TOL)
