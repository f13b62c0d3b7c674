"""The compile -> compressor12 route of the port on the CPU against the
JAX package's (the reference's route, tests/test_circom_dsl.py::
test_compile_over_goldilocks_feeds_compressor), tolerance 0.

bench_circom.compressor_route over GLSquareChain(2) (data/circuits/, 2^7
compressor rows, the smallest trace): compiled over Goldilocks, packed
into the 12-column PIL, its files written and proved through the port's
file-based stark_prove on Engine("cpu"), which writes the verifier's
circom text; the skip_main render beside it.  The JAX package does the
same with its compiler, PlonkSetup and stark_prove (host engine): the
files, the zkin and both renders are equal.  One torch thread.
"""
import os

import pytest
import torch

from eigen_zkvm_tpu_torch import bench_circom as bc

from test_torch_circom_cuda import host_glsquare_digests, route_digests

N = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_compressor_route_gives_the_jax_files_zkin_and_renders(monkeypatch,
                                                               tmp_path):
    monkeypatch.setenv("EIGEN_ZKVM_ENGINE", "host")
    for side in ("port", "jax"):
        (tmp_path / side).mkdir()
    rec, texts = bc.compressor_route(bc.source(bc.GLSQUARE, N),
                                     bc.GLSQUARE_INPUTS, "cpu",
                                     out_dir=str(tmp_path / "port"))
    want = host_glsquare_digests(N, tmp_path / "jax")
    for name in ("pil", "struct", "const", "cm", "zkin", "circom"):
        with open(os.path.join(tmp_path, "port", f"c12.{name}"), "rb") as f, \
                open(os.path.join(tmp_path, "jax", f"c12.{name}"), "rb") as g:
            assert f.read() == g.read(), name
    assert route_digests({}, rec["digests"]) == want
    assert (rec["n_bits"], rec["publics"]) == (7, 2)
    assert texts["skip_main"].endswith(
        "component main {public [publics]}= StarkVerifier();\n")
    assert "template Main()" in texts["default"]
