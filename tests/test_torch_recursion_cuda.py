"""The GL recursion layers of the port on the card (marked cuda; skipped
without one).  Imports nothing of JAX: run it on the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda -s tests/test_torch_recursion_cuda.py

The fibonacci AIR at 2^10 rows and 2 queries (examples/fibonacci.py),
proved with the inputs (1, 2) and (2, 3) on the card, goes through
bench_recursion.run_layers: c12 of each (2^13 rows), recursive1 of each and
the aggregation of the pair (join_zkin), both at 2^FIB_FORCE rows.  Each
layer launches the NTT and Poseidon kernels, and each zkin's sha256 is the
JAX package's host engine's (FIB_CHAIN_SHA256;
tests/test_torch_recursion.py::test_host_engine_gives_the_pinned_fibonacci_chain_digests
recomputes them on the CPU).
"""
import pytest
import torch

FIB_NBITS, FIB_QUERIES, FIB_FORCE = 10, 2, 15
FIB_INPUTS = ((1, 2), (2, 3))
FIB_CHAIN_SHA256 = {
    "c12 0":
        "752ad37e40a413fe5cc0abf1d4e72a72742cc7ea65bb5b92e4b503ecb3c3be5d",
    "recursive1 0":
        "da888dbe04716dbe0ab228c341d0291ea010d7756a45937d3fb03fbe88acb0f8",
    "c12 1":
        "77c2566837786b0bcbf08ea9aac6ad98ca3081bdbe9cc711c089a61fcdd3fca6",
    "recursive1 1":
        "f614c2a0f91294696664216e211fc327655a6a7cc9c73557f429aef3706f00cf",
    "aggregation":
        "e7cca81236fcf3428d0890eeca578cbe9b387f364e17a3b6cc2aee0476b1c038",
}


@pytest.mark.cuda
def test_fibonacci_chain_on_the_card_matches_the_pinned_digests():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from eigen_zkvm_tpu_torch import bench_recursion
    from eigen_zkvm_tpu_torch.examples import fibonacci
    from eigen_zkvm_tpu_torch.stark.engine import Engine
    from eigen_zkvm_tpu_torch.stark.serializer import stark_proof_to_dict
    from eigen_zkvm_tpu_torch.stark.stark_gen import stark_gen
    from eigen_zkvm_tpu_torch.stark.stark_setup import StarkSetup
    from eigen_zkvm_tpu_torch.stark.types import StarkStruct, Step

    engine = Engine()
    pil, cp, mk = fibonacci.build(FIB_NBITS)
    ss = StarkStruct(nBits=FIB_NBITS, nBitsExt=FIB_NBITS + 1,
                     nQueries=FIB_QUERIES, verificationHashType="GL",
                     steps=[Step(FIB_NBITS + 1), Step(5)])
    setup = StarkSetup(cp, pil, ss, engine)
    zkins = [stark_proof_to_dict(stark_gen(
        mk(inputs), cp, setup.const_tree, setup.starkinfo, setup.program, ss,
        engine=engine), "GL") for inputs in FIB_INPUTS]
    records, _ = bench_recursion.run_layers(zkins, setup, ss, engine,
                                            FIB_QUERIES, FIB_FORCE)
    for r in records:
        assert r["launches"]["ntt"] > 0 and r["launches"]["poseidon_gl"] > 0
    got = {r["layer"]: r["zkin_sha256"] for r in records}
    assert got == FIB_CHAIN_SHA256, got
