"""The port's whole slice on the CPU: StarkSetup + stark_gen with
Engine("cpu"), which runs the resident prover (commits, VM, Q split,
openings, FRI folds) on CPU tensors with the kernels' plain versions.  Each
proof's JSON must be byte-identical to the JAX package's host prove of the
same inputs (and to its resident engine on JAX's CPU backend), and the
port's own stark_verify must accept it.  Fixtures are built in-repo
(examples/, scripts/bench_big.py).  The port must import nothing of the
JAX package, and run on the CPU only when asked.

The last test proves chip_smoke.py's chain AIR on the card with the port
and with eigen_zkvm_tpu's host engine; it imports no JAX, so it runs where
JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_prove.py
"""
import ast
import glob
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from eigen_zkvm_tpu.cli import _pil_to_json
from eigen_zkvm_tpu.examples import (connection, fibonacci, permutation,
                                     plookup, poseidon, simple_vm)
from eigen_zkvm_tpu.stark import prove as host_prove
from eigen_zkvm_tpu.stark import stark_gen as host_gen
from eigen_zkvm_tpu.stark import stark_setup as host_setup
from eigen_zkvm_tpu.stark.serializer import stark_proof_to_json
from eigen_zkvm_tpu.stark.stark_verify import stark_verify as host_verify
from eigen_zkvm_tpu.stark.types import StarkStruct, Step
from eigen_zkvm_tpu_torch import bench_chain, kernels
from eigen_zkvm_tpu_torch.stark import prove as port_prove
from eigen_zkvm_tpu_torch.stark import serializer as port_serializer
from eigen_zkvm_tpu_torch.stark.engine import Engine
from eigen_zkvm_tpu_torch.stark.stark_gen import stark_gen
from eigen_zkvm_tpu_torch.stark.stark_setup import StarkSetup
from eigen_zkvm_tpu_torch.stark.stark_verify import stark_verify

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ss(nbits, queries=3, steps=None):
    steps = steps or [nbits + 1, 3]
    return StarkStruct(nBits=nbits, nBitsExt=nbits + 1, nQueries=queries,
                       verificationHashType="GL",
                       steps=[Step(s) for s in steps])


def _host_json(pil, cp, cm, ss):
    setup = host_setup.StarkSetup(cp, pil, ss)
    return stark_proof_to_json(host_gen.stark_gen(
        cm, cp, setup.const_tree, setup.starkinfo, setup.program, ss))


def _port_setup_and_proof(pil, cp, cm, ss):
    engine = Engine("cpu")
    setup = StarkSetup(cp, pil, ss, engine)
    proof = stark_gen(cm, cp, setup.const_tree, setup.starkinfo,
                      setup.program, ss, engine=engine)
    assert stark_verify(proof, setup.const_root, setup.starkinfo, ss,
                        setup.program)
    return setup, proof


def _port_proof(pil, cp, cm, ss):
    return _port_setup_and_proof(pil, cp, cm, ss)[1]


def _case(name):
    if name == "simple_vm":
        pil, cp, mk, _, _ = simple_vm.build(8)
        return pil, cp, mk([6, 3, 120, 40, 99, 100, 7]), _ss(8, 2)
    if name == "poseidon":
        pil, cp, mk, _ = poseidon.build(6)
        return pil, cp, mk(list(range(1, 13))), _ss(6, 2)
    if name == "chain":
        pil, cp, cm = bench_chain.build_chain_air(10, 8)
        return pil, cp, cm, bench_chain.chain_struct(10, 8)
    mod = {"fibonacci": fibonacci, "plookup": plookup,
           "permutation": permutation, "connection": connection}[name]
    pil, cp, mk = mod.build(5)
    return pil, cp, mk(), _ss(5)


@pytest.mark.parametrize("name", ["fibonacci", "plookup", "permutation",
                                  "connection", "simple_vm", "poseidon",
                                  "chain"])
def test_port_proof_is_byte_identical_to_host_engine(monkeypatch, name):
    monkeypatch.setenv("EIGEN_ZKVM_ENGINE", "host")
    pil, cp, cm, ss = _case(name)
    before = kernels.counts()
    proof = _port_proof(pil, cp, cm, ss)
    assert kernels.counts() == before   # CPU tensors: plain versions only
    assert stark_proof_to_json(proof) == _host_json(pil, cp, cm, ss)


@pytest.mark.parametrize("jax_vm", ["0", "1"])
def test_port_proof_matches_jax_device_commit_on_cpu(monkeypatch, jax_vm):
    """The JAX package's own device configurations, run on its CPU backend:
    device commits with the host VM, and the resident engine (commit, VM
    and FRI chain on the device engine), which the port follows."""
    monkeypatch.setenv("EIGEN_ZKVM_ENGINE", "host")
    monkeypatch.setenv("EIGEN_ZKVM_TPU_COMMIT", "1")
    monkeypatch.setenv("EIGEN_ZKVM_TPU_VM", jax_vm)
    pil, cp, mk = fibonacci.build(4)
    cm = mk()
    ss = _ss(4, 3, [5])
    want = _host_json(pil, cp, cm, ss)
    assert stark_proof_to_json(_port_proof(pil, cp, cm, ss)) == want


def test_file_based_stark_prove_matches_host(monkeypatch, tmp_path):
    import json

    monkeypatch.setenv("EIGEN_ZKVM_ENGINE", "host")
    pil, cp, mk = fibonacci.build(5)   # its PIL JSON is the reference's
    files = {k: str(tmp_path / k) for k in ("pil", "ss", "const", "cm")}
    with open(files["pil"], "w") as f:
        json.dump(_pil_to_json(pil), f)
    with open(files["ss"], "w") as f:
        json.dump({"nBits": 5, "nBitsExt": 6, "nQueries": 3,
                   "verificationHashType": "GL",
                   "steps": [{"nBits": 6}, {"nBits": 3}]}, f)
    cp.save(files["const"])
    mk().save(files["cm"])
    args = (files["ss"], files["pil"], files["const"], files["cm"])
    port_out, host_out = str(tmp_path / "port.json"), str(tmp_path / "host.json")
    proof, setup = port_prove.stark_prove(*args, zkin_out=port_out,
                                          device="cpu")
    assert np.array_equal(proof.rootC, setup.const_root)
    host_prove.stark_prove(*args, zkin_out=host_out)
    with open(port_out) as a, open(host_out) as b:
        assert a.read() == b.read()


def test_proving_with_the_port_never_imports_jax():
    """A prove and verify through the port's own modules alone (its chain
    AIR, setup, prover, verifier, serializer) loads neither JAX nor any
    module of the JAX package."""
    code = textwrap.dedent("""
        import sys
        from eigen_zkvm_tpu_torch import bench_chain
        from eigen_zkvm_tpu_torch.stark.engine import Engine
        from eigen_zkvm_tpu_torch.stark.serializer import stark_proof_to_json
        from eigen_zkvm_tpu_torch.stark.stark_gen import stark_gen
        from eigen_zkvm_tpu_torch.stark.stark_setup import StarkSetup
        from eigen_zkvm_tpu_torch.stark.stark_verify import stark_verify
        from eigen_zkvm_tpu_torch import bench_groth16, convert
        from eigen_zkvm_tpu_torch.curves import bn254
        from eigen_zkvm_tpu_torch.groth16 import api, groth16
        from eigen_zkvm_tpu_torch.kernels import bn254_check
        from eigen_zkvm_tpu_torch.ops import bigint, ec, fr_ntt, r1cs
        circ = bench_groth16.synthetic(12, 2, seed=1)
        assert bench_groth16.check(circ)
        x = bigint.mont_ints(bigint.FR, circ.w[:8])
        assert fr_ntt.ntt(fr_ntt.ntt(x, 3), 3, inverse=True).shape == (8, 4)
        assert ec.affine_ints(ec.G1, ec.affine_tensor(
            ec.G1, [bn254.G1_GEN])) == [bn254.G1_GEN]
        pil, cp, cm = bench_chain.build_chain_air(4, 2)
        ss = bench_chain.chain_struct(4, 2)
        e = Engine("cpu")
        s = StarkSetup(cp, pil, ss, e)
        p = stark_gen(cm, cp, s.const_tree, s.starkinfo, s.program, ss,
                      engine=e)
        assert stark_verify(p, s.const_root, s.starkinfo, ss, s.program)
        stark_proof_to_json(p)
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "eigen_zkvm_tpu")]
        assert not bad, bad
        print("SELF-CONTAINED")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "SELF-CONTAINED" in r.stdout


def _imports(path):
    """Module names a source file imports (absolute, as written)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_nothing_of_the_jax_package():
    files = glob.glob(os.path.join(ROOT, "eigen_zkvm_tpu_torch", "**",
                                   "*.py"), recursive=True)
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 20
    dirs = {os.path.relpath(os.path.dirname(f), ROOT) for f in files}
    assert {"eigen_zkvm_tpu_torch/curves", "eigen_zkvm_tpu_torch/groth16",
            "eigen_zkvm_tpu_torch/ops"} <= dirs
    bad = [(os.path.relpath(f, ROOT), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "eigen_zkvm_tpu")]
    assert not bad, bad


def test_cuda_sources_include_only_their_own_headers():
    """csrc/*.cu and *.cuh include system headers (<...>) and headers of
    csrc itself, nothing of the JAX package's native/ sources."""
    csrc = os.path.join(ROOT, "eigen_zkvm_tpu_torch", "csrc")
    files = glob.glob(os.path.join(csrc, "*.cu*"))
    assert {"bn254.cuh", "msm.cu", "ec_batch.cu", "fr_ntt.cu",
            "r1cs.cu"} <= {os.path.basename(f) for f in files}
    bad = []
    for f in files:
        with open(f) as fh:
            for line in fh:
                line = line.strip()
                if not line.startswith("#include"):
                    continue
                name = line.split(None, 1)[1]
                if name.startswith("<"):
                    continue
                local = name.strip('"')
                if "/" in local or not os.path.exists(
                        os.path.join(csrc, local)):
                    bad.append((os.path.basename(f), name))
    assert not bad, bad


def test_kernel_build_recompiles_only_stale_sources(tmp_path):
    """kernels.build on fake sources with a fake nvcc (no toolkit): an empty
    build directory compiles every source; a rebuild compiles nothing; an
    edit of one .cu recompiles that one, an edit of a header the sources
    that include it (directly or through another header); `force` all; a
    lost library relinks without compiling."""
    from eigen_zkvm_tpu_torch import kernels

    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    files = {"a.cu": '#include "h.cuh"\n#include <cstdint>\n',
             "b.cu": "#include <cstdint>\n", "c.cu": '#include "g.cuh"\n',
             "h.cuh": "// h\n", "g.cuh": '#include "h.cuh"\n'}
    for name, text in files.items():
        (csrc / name).write_text(text)
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    "a = sys.argv[1:]\n"
                    "open(a[a.index('-o') + 1], 'w').write(' '.join(a))\n")
    nvcc.chmod(0o755)

    def build(force=False):
        return kernels.build(force, str(csrc), str(out), str(nvcc))

    assert build()["compiled"] == ["a.cu", "b.cu", "c.cu"]
    lib = out / os.path.basename(kernels.LIB_PATH)
    assert lib.exists()
    assert build() == {"seconds": 0.0, "compiled": [], "log": ""}
    (csrc / "b.cu").write_text("#include <cstdint>\n// edited\n")
    assert build()["compiled"] == ["b.cu"]
    (csrc / "h.cuh").write_text("// h, edited\n")
    assert build()["compiled"] == ["a.cu", "c.cu"]
    (csrc / "g.cuh").write_text('#include "h.cuh"\n// edited\n')
    assert build()["compiled"] == ["c.cu"]
    assert build()["compiled"] == []
    assert build(force=True)["compiled"] == ["a.cu", "b.cu", "c.cu"]
    lib.unlink()
    assert build()["compiled"] == [] and lib.exists()
    assert sorted(p.name for p in out.iterdir()) == sorted(
        [lib.name, lib.name + ".stamp"]
        + [f"{s}.o{x}" for s in ("a.cu", "b.cu", "c.cu")
           for x in ("", ".stamp")])


def test_engine_names_its_device():
    assert repr(Engine("cpu")) == "Engine(device=cpu, resident=True)"
    assert Engine(torch.device("cpu")).device == torch.device("cpu")


def test_engine_without_cuda_raises(monkeypatch, tmp_path):
    """No CUDA device: the default engine raises; only "cpu" runs there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_prove.stark_prove("ss.json", "pil.json", "c", "m")
    assert Engine("cpu").device.type == "cpu"


def test_port_verifier_accepts_and_rejects_tampering():
    pil, cp, mk = plookup.build(5)
    ss = _ss(5)
    setup, proof = _port_setup_and_proof(pil, cp, mk(), ss)
    args = (setup.const_root, setup.starkinfo, ss, setup.program)
    text = port_serializer.stark_proof_to_json(proof)
    assert stark_verify(port_serializer.stark_proof_from_json(text), *args)
    d = json.loads(text)
    d["evals"][0][1] = str((int(d["evals"][0][1]) + 1) % 0xFFFFFFFF00000001)
    assert not stark_verify(port_serializer.stark_proof_from_dict(d), *args)
    d = json.loads(text)
    d["s0_vals1"][1][0] = str(int(d["s0_vals1"][1][0]) ^ 1)
    assert not stark_verify(port_serializer.stark_proof_from_dict(d), *args)
    d = json.loads(text)
    d["finalPol"][0][0] = str(int(d["finalPol"][0][0]) ^ 1)
    assert not stark_verify(port_serializer.stark_proof_from_dict(d), *args)
    # and the JAX package's verifier agrees with the untouched proof
    hsetup = host_setup.StarkSetup(cp, pil, ss)
    from eigen_zkvm_tpu.stark.serializer import stark_proof_from_json
    assert host_verify(stark_proof_from_json(text), hsetup.const_root,
                       hsetup.starkinfo, ss, hsetup.program)


def test_chain_air_files_equal_bench_big(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "bench_big", os.path.join(ROOT, "scripts", "bench_big.py"))
    bench_big = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_big)
    pil, cp, cm = bench_big.build_chain_air(6, 3)
    ppil, pcp, pcm = bench_chain.build_chain_air(6, 3)
    assert bench_chain.pil_to_json(ppil) == _pil_to_json(pil)
    assert np.array_equal(pcp.buffer, cp.buffer)
    assert np.array_equal(pcm.buffer, cm.buffer)
    files = bench_chain.write_chain_files(str(tmp_path), 6, 3, 4)
    with open(files["pil"]) as f:
        assert json.load(f) == _pil_to_json(pil)
    assert np.array_equal(np.fromfile(files["cm"], dtype="<u8"),
                          cm.buffer.reshape(-1))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_port_on_the_card_matches_host_engine_at_smoke_size(monkeypatch,
                                                           tmp_path):
    """chip_smoke.py's chain AIR (2^20 x 8) through both file-based
    stark_prove entries: the port, resident on the card, and
    eigen_zkvm_tpu's host engine; both walls are printed.  The zkin JSON files must be
    byte-identical, and their sha256 must be chip_smoke.HOST_PROOF_SHA256,
    the digest the smoke holds its own prove to."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("EIGEN_ZKVM_ENGINE", "host")
    smoke = _smoke()
    files = bench_chain.write_chain_files(str(tmp_path), smoke.NBITS,
                                          smoke.WIDTH, smoke.QUERIES)
    args = (files["stark_struct"], files["pil"], files["const"], files["cm"])
    port_out, host_out = str(tmp_path / "port.json"), str(tmp_path / "host.json")
    before = kernels.counts()
    t0 = time.perf_counter()
    port_prove.stark_prove(*args, zkin_out=port_out)   # the default: cuda
    t1 = time.perf_counter()
    assert all(kernels.counts()[k] > n for k, n in before.items())
    host_prove.stark_prove(*args, zkin_out=host_out)
    t2 = time.perf_counter()
    print(f"load + setup + prove + verify: port {t1 - t0:.3f} s, host "
          f"engine {t2 - t1:.3f} s")
    with open(port_out, "rb") as a, open(host_out, "rb") as b:
        port_json, host_json = a.read(), b.read()
    assert port_json == host_json
    digest = hashlib.sha256(host_json).hexdigest()
    assert digest == smoke.HOST_PROOF_SHA256, f"host engine's digest {digest}"
