"""recursive1 of the port on the CPU against the JAX package's host engine.

The c12 proof of the fibonacci AIR (2^10 rows, 2 queries:
tests/test_torch_recursion.py holds it byte for byte) goes through a
second verifier circuit (StarkOption(): publics and rootC as public
inputs, the embedded const root) at its natural 2^14 rows: the port's
compressor setup of it is the JAX package's field by field, and the
recursive1 proof JSON is the JAX host engine's.  The c12 layer's
verifier rendered as circom text (stark/pil2circom.py) is the JAX
package's, with and without agg_stage.  One torch thread.
"""
import json

import numpy as np
import pytest

from eigen_zkvm_tpu.recursion import compressor12 as j_c12
from eigen_zkvm_tpu.stark import pil2circom as j_p2c
from eigen_zkvm_tpu.stark.serializer import stark_proof_to_dict as j_dict
from eigen_zkvm_tpu_torch import bench_circom, convert
from eigen_zkvm_tpu_torch.bench_chain import pil_to_json
from eigen_zkvm_tpu_torch.recursion import compressor12
from eigen_zkvm_tpu_torch.stark.serializer import stark_proof_to_dict
from eigen_zkvm_tpu_torch.stark.stark_setup import StarkSetup

from test_torch_recursion import (CPU, FIB_QUERIES, Fib, _host_engine,  # noqa: F401
                                  _one_thread)


@pytest.fixture(scope="module")
def c12():
    """The c12 layer of the fibonacci proof: the JAX package's proof and
    bundle, and the port's own setup of the same circuit (its PlonkSetup
    and a StarkSetup on the CPU)."""
    fib = Fib()
    opt = compressor12.StarkOption(skip_main=True)
    j_proof, (j_st, j_ss, j_ps) = j_c12.prove_compressed(
        fib.j_zkin, fib.j_setup, fib.j_ss, j_c12.StarkOption(skip_main=True),
        n_queries=FIB_QUERIES)
    _, ps = compressor12.compressor12_setup(fib.zkin, fib.setup, fib.ss, opt)
    ss = compressor12.default_compressor_struct(ps.n_bits, FIB_QUERIES)
    st = StarkSetup(ps.const_pols, ps.pil, ss, CPU)
    return dict(zkin=j_dict(j_proof, "GL"), j_bundle=(j_st, j_ss, j_ps),
                setup=st, ss=ss, psetup=ps)


def test_c12_setup_and_const_root_match(c12):
    j_st, j_ss, j_ps = c12["j_bundle"]
    assert convert.struct_from_jax(j_ss) == c12["ss"]
    want = convert.plonk_setup_from_jax(j_ps)
    assert np.array_equal(c12["psetup"].const_pols.buffer,
                          want.const_pols.buffer)
    assert [int(x) for x in c12["setup"].const_root] == \
        [int(x) for x in j_st.const_root]
    assert c12["zkin"]["rootC"] == [str(int(x)) for x in j_st.const_root]


def test_recursive1_proof_is_the_jax_packages(c12):
    """recursive1 at its natural size (no force): the setup's PIL,
    constants, s_map and additions, then the proof JSON, byte for byte."""
    j_st, j_ss, _ = c12["j_bundle"]
    j_proof, (_, j_ss1, j_ps1) = j_c12.prove_compressed(
        c12["zkin"], j_st, j_ss, j_c12.StarkOption(), n_queries=FIB_QUERIES)
    proof, (_, ss1, ps1) = compressor12.prove_compressed(
        c12["zkin"], c12["setup"], c12["ss"], compressor12.StarkOption(),
        n_queries=FIB_QUERIES, engine=CPU)
    want = convert.plonk_setup_from_jax(j_ps1)
    assert (ps1.n_bits, ps1.n_publics) == (14, 5)    # out + 4 rootC limbs
    assert ps1.n_used == want.n_used
    assert json.dumps(pil_to_json(ps1.pil)) == json.dumps(
        pil_to_json(want.pil))
    assert np.array_equal(ps1.const_pols.buffer, want.const_pols.buffer)
    assert np.array_equal(ps1.s_map, want.s_map)
    assert convert.struct_from_jax(j_ss1) == ss1
    got = stark_proof_to_dict(proof, "GL")
    assert got == j_dict(j_proof, "GL")
    assert got["publics"][0] == c12["zkin"]["publics"][0]


@pytest.mark.parametrize("options", [
    {}, {"verkey_input": True, "agg_stage": True}, {"skip_main": True}],
    ids=["recursive1", "aggregation", "skip_main"])
def test_c12_layer_render_is_the_jax_text(c12, options):
    """The c12 proof's verifier as circom text, with the options the next
    layer's setup gets (bench_circom.LAYER_OPTIONS), byte for byte."""
    j_st, j_ss, j_ps = c12["j_bundle"]
    want = j_p2c.pil2circom(j_ps.pil, j_st.const_root, j_ss, j_st.starkinfo,
                            j_st.program, j_p2c.StarkOption(**options))
    got = bench_circom.render(c12["psetup"].pil, c12["setup"], c12["ss"],
                              options)
    assert got == want
    assert ("template Main()" in got) == (not options.get("skip_main"))
