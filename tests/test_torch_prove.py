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
from eigen_zkvm_tpu_torch.examples import poseidon as port_poseidon
from eigen_zkvm_tpu_torch.examples import simple_vm as port_simple_vm
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


def _case(name, port=False):
    """(pil, const pols, trace, struct) of a case; with `port`, the
    Poseidon and simple-VM AIRs come from the port's own copies (the JAX
    package's modules are the host engine's reference)."""
    if name == "simple_vm":
        mod = port_simple_vm if port else simple_vm
        pil, cp, mk, _, _ = mod.build(8)
        return pil, cp, mk([6, 3, 120, 40, 99, 100, 7]), _ss(8, 2)
    if name == "poseidon":
        mod = port_poseidon if port else poseidon
        pil, cp, mk, _ = mod.build(6)
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
    pil, cp, cm, ss = _case(name, port=True)
    before = kernels.counts()
    proof = _port_proof(pil, cp, cm, ss)
    assert kernels.counts() == before   # CPU tensors: plain versions only
    assert stark_proof_to_json(proof) == _host_json(*_case(name))


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
        from eigen_zkvm_tpu_torch import bench_zkvm
        from eigen_zkvm_tpu_torch.zkvm import (continuations, elf, lib,
                                               machine, rv32, rv32_lib,
                                               rv32_native)
        from eigen_zkvm_tpu_torch import bench_recursion, cli
        from eigen_zkvm_tpu_torch.examples import fibonacci
        from eigen_zkvm_tpu_torch.recursion import (
            aggregation, circuit, compressor12, compressor12_pil, gadgets,
            plonk_setup, r1cs2plonk, stark_verifier_circuit)
        from eigen_zkvm_tpu_torch import bench_e2e
        from eigen_zkvm_tpu_torch.hash import poseidon_bn128
        from eigen_zkvm_tpu_torch.recursion import (gl_in_fr,
                                                    stark_verifier_circuit_bn)
        from eigen_zkvm_tpu_torch import bench_circom
        from eigen_zkvm_tpu_torch.dsl import circom, elaborate, simplify
        from eigen_zkvm_tpu_torch.stark import (pil2circom,
                                                pil2circom_onchain)
        from eigen_zkvm_tpu_torch.zkvm import (
            cc, evm, guest_evm_c, guest_keccak, guest_lr, guest_secp256k1,
            guests, guests_llvm, llvm_backend)
        from eigen_zkvm_tpu_torch import bench_sharded
        from eigen_zkvm_tpu_torch.parallel import (launch, meshctx, sharded,
                                                   sharded_prove)
        from eigen_zkvm_tpu_torch.algebraic import wasmvm, witness_calculator
        from eigen_zkvm_tpu_torch.examples import poseidon, simple_vm
        from eigen_zkvm_tpu_torch.onchain import SolContract, solvm
        from eigen_zkvm_tpu_torch.ops import f5
        from eigen_zkvm_tpu_torch import bench_fri
        from eigen_zkvm_tpu_torch.stark import fri
        from eigen_zkvm_tpu_torch.stark.backends import get_backend
        assert cc.c_execute("int main() { return 6 * 7; }")[1] == 42
        assert guest_secp256k1.P == 2**256 - 2**32 - 977
        assert guest_keccak.keccak256_ref(b"").hex().startswith("c5d246")
        assert guest_lr.lr_reference([(1, 3), (2, 5)]) == (2 << 16, 1 << 16)
        assert evm.evm256_reference(bytes([0x60, 7]))[0] == 7
        assert len(guests.FIBONACCI) and guest_evm_c.TOKEN_A0
        assert len(guests_llvm.load_fixture("crc32")) > 0
        llvm_backend.available()
        nc = rv32_native.NativeChunker(
            rv32_lib.program_from_asm("li a0, 5\\necall"), 0, n_bits=5)
        assert nc.final.regs[10] == 5 and len(continuations.ram_digest(
            [0] * 8)) == 4
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
        b = circuit.CircuitBuilder()   # the F3 gadgets reach ops/f3.py
        x = tuple(b.wire(b.sig(v)) for v in (3, 5, 7))
        b.f3_inv(b.f3_mul(x, x, x))
        b.ev_pol4([x] * 4, x, x)
        assert b.check()
        fb = circuit.CircuitBuilder(prime=bn254.R)   # the snark-field gadgets
        g = gl_in_fr.GlCircuit(fb)
        g.f3_inv(g.f3_input((3, 5, 7)))
        h = gl_in_fr.PoseidonFrCircuit(fb, poseidon_bn128).hash_fr(
            [fb.wire(fb.sig(1))], fb.W())
        assert fb.val(h) == poseidon_bn128.hash_fr([1]) and fb.check()
        assert callable(stark_verifier_circuit_bn.build_final_main)
        assert [s.nBits for s in bench_e2e.final_struct(18, 4).steps] == [
            19, 15, 11, 7, 3]
        text = bench_circom.source(bench_circom.GLMUL, 2)
        assert circom.parse(text)["main"]
        cb = elaborate.compile_circom(text, bench_circom.GLMUL_INPUTS,
                                      prime=bn254.R)
        simplify.simplify(cb, 2)
        assert cb.check() and len(cb.constraints) == 2 * 129
        assert callable(pil2circom.pil2circom)
        assert callable(pil2circom_onchain.render_onchain)
        assert callable(sharded_prove.sharded_prove) and callable(
            sharded.make_sharded_commit) and callable(launch.RankPool)
        assert callable(meshctx.Mesh) and callable(bench_sharded.main)
        assert f5.mul_int(f5.ONE_INT, (1, 2, 3, 4, 5)) == (1, 2, 3, 4, 5)
        assert fri.FRI(ss, get_backend("GL"), dim=5).dim == 5
        assert bench_fri.coeffs(2, 1).shape == (4, 5)
        assert len(poseidon.build(6)[3](list(range(12)))) == 4
        assert simple_vm.build(8)[3]([2, 5, 200]) == (6, 1)
        assert callable(SolContract) and solvm.U256 == 2**256 - 1
        assert witness_calculator.fnv64("") == (0xCBF29CE4, 0x84222325)
        assert callable(wasmvm.Instance)
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
            "eigen_zkvm_tpu_torch/ops", "eigen_zkvm_tpu_torch/zkvm"} <= dirs
    assert os.path.join(ROOT, "eigen_zkvm_tpu_torch", "zkvm",
                        "rv32_native.py") in files
    assert {os.path.join(ROOT, "eigen_zkvm_tpu_torch", *p) for p in (
        ("dsl", "circom.py"), ("dsl", "elaborate.py"), ("dsl", "simplify.py"),
        ("stark", "pil2circom.py"), ("stark", "pil2circom_onchain.py"),
        ("bench_circom.py",))} <= set(files)
    assert {os.path.join(ROOT, "eigen_zkvm_tpu_torch", "zkvm", f"{m}.py")
            for m in ("cc", "llvm_backend", "guests_llvm", "guest_keccak",
                      "guest_secp256k1", "guest_evm_c", "evm", "guest_lr",
                      "guests")} <= set(files)
    assert {os.path.join(ROOT, "eigen_zkvm_tpu_torch", *p) for p in (
        ("parallel", "meshctx.py"), ("parallel", "launch.py"),
        ("parallel", "sharded.py"), ("parallel", "sharded_prove.py"),
        ("bench_sharded.py",))} <= set(files)
    assert {os.path.join(ROOT, "eigen_zkvm_tpu_torch", *p) for p in (
        ("ops", "f5.py"), ("examples", "poseidon.py"),
        ("examples", "simple_vm.py"), ("onchain", "__init__.py"),
        ("onchain", "solvm.py"), ("algebraic", "wasmvm.py"),
        ("algebraic", "witness_calculator.py"), ("bench_fri.py",))} <= set(
        files)
    bad = [(os.path.relpath(f, ROOT), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "eigen_zkvm_tpu")]
    assert not bad, bad


def test_chip_smoke_needs_neither_pycparser_nor_libllvm():
    """chip_smoke.py imports neither toolchain (the card's machine has
    neither pycparser nor libLLVM), and what its guests phase imports loads
    and runs the committed guests with pycparser blocked and no libLLVM."""
    names = set()
    for path in (os.path.join(ROOT, "chip_smoke.py"), os.path.join(
            ROOT, "eigen_zkvm_tpu_torch", "bench_guests.py")):
        names.update(_imports(path))
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                names.update(f"{node.module}.{a.name}" for a in node.names)
    assert not [n for n in names if n.split(".")[-1] in (
        "cc", "llvm_backend", "pycparser")], names
    code = textwrap.dedent("""
        import sys
        sys.modules["pycparser"] = None     # any import of it fails
        import chip_smoke
        from eigen_zkvm_tpu_torch import bench_guests
        runs = bench_guests.run_elfs()
        assert len(runs) == 4 and all(r["ok"] for r in runs), runs
        from eigen_zkvm_tpu_torch.zkvm import evm
        assert evm.run_evm256(bytes([0x60, 7]))[0] == 7
        bad = [m for m in sys.modules if m.split(".")[-1] in (
            "cc", "llvm_backend", "pycparser") and sys.modules[m]]
        assert not bad, bad
        print("NO-TOOLCHAIN")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "NO-TOOLCHAIN" in r.stdout


def _relative_imports(path):
    """(level, module, names) of each relative import in a source file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level > 0:
            yield node.level, node.module, [a.name for a in node.names]


def test_port_relative_imports_stay_in_the_port():
    """Every relative import of the port resolves to a module or package of
    the port's own tree (a copied `from ..fields import f3g` names a
    package the port lacks: it would pass the absolute-import scan and
    fail only when a gadget first runs)."""
    pkg = os.path.join(ROOT, "eigen_zkvm_tpu_torch")
    files = glob.glob(os.path.join(pkg, "**", "*.py"), recursive=True)
    assert os.path.join(pkg, "recursion", "circuit.py") in files
    assert os.path.join(pkg, "recursion",
                        "stark_verifier_circuit_bn.py") in files
    assert not _unresolved_relative_imports(ROOT, files)


def test_the_relative_import_check_catches_a_copied_jax_import(tmp_path):
    """The check above flags the JAX package's `from ..fields import gl64`
    pasted back into a copy of the port's on-chain verifier circuit, and
    nothing else of the copied tree."""
    import shutil

    shutil.copytree(os.path.join(ROOT, "eigen_zkvm_tpu_torch"),
                    tmp_path / "eigen_zkvm_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "data", "csrc",
                                                  "__pycache__"))
    f = tmp_path / "eigen_zkvm_tpu_torch" / "recursion" / \
        "stark_verifier_circuit_bn.py"
    src = f.read_text()
    assert "from ..ops import gl as gl64mod\n" in src
    f.write_text(src.replace("from ..ops import gl as gl64mod\n",
                             "from ..fields import gl64 as gl64mod\n"))
    files = glob.glob(os.path.join(tmp_path, "eigen_zkvm_tpu_torch", "**",
                                   "*.py"), recursive=True)
    bad = _unresolved_relative_imports(str(tmp_path), files)
    assert [b[:3] for b in bad] == [(os.path.join(
        "eigen_zkvm_tpu_torch", "recursion", "stark_verifier_circuit_bn.py"),
        2, "fields")]


def _unresolved_relative_imports(root: str, files: list) -> list:
    """(file, level, module, ...) of each relative import in `files` (under
    root/eigen_zkvm_tpu_torch) that names no module or package of that
    tree."""
    def exists(parts):
        path = os.path.join(root, *parts)
        return os.path.isfile(path + ".py") or os.path.isfile(
            os.path.join(path, "__init__.py"))

    def defined(parts, name):
        """`name` is a submodule of the package or defined in its
        __init__.py."""
        if exists(parts + [name]):
            return True
        init = os.path.join(root, *parts, "__init__.py")
        if not os.path.isfile(init):
            return False
        with open(init) as fh:
            tree = ast.parse(fh.read())
        return any(getattr(n, "name", None) == name or any(
            getattr(t, "id", None) == name for t in getattr(n, "targets", []))
            for n in tree.body)

    bad = []
    for f in files:
        here = os.path.relpath(os.path.dirname(f), root).split(os.sep)
        for level, module, names in _relative_imports(f):
            base = here[: len(here) - (level - 1)]
            if level - 1 >= len(here) or base[0] != "eigen_zkvm_tpu_torch":
                bad.append((os.path.relpath(f, root), level, module))
                continue
            if module:
                ok = exists(base + module.split("."))
            else:
                ok = all(defined(base, n) for n in names)
            if not ok:
                bad.append((os.path.relpath(f, root), level, module, names))
    return bad


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

    info = build()
    assert info["compiled"] == ["a.cu", "b.cu", "c.cu"]
    assert sorted(j["source"] for j in info["jobs"]) == info["compiled"]
    assert all(0.0 <= j["seconds"] <= info["seconds"] and j["ptxas"] == []
               for j in info["jobs"])
    lib = out / os.path.basename(kernels.LIB_PATH)
    assert lib.exists()
    assert build() == {"seconds": 0.0, "compiled": [], "log": "",
                       "jobs": []}
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


def test_ptxas_report_names_each_kernel():
    """kernels.ptxas_report: ptxas's -v lines of one compile, each register
    and spill line under the kernel it follows."""
    from eigen_zkvm_tpu_torch import kernels

    log = ("ptxas info    : 0 bytes gmem\n"
           "ptxas info    : Compiling entry function '_Z1aPi' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z1aPi\n"
           "    912 bytes stack frame, 3776 bytes spill stores, 3776 bytes "
           "spill loads\n"
           "ptxas info    : Used 255 registers, used 0 barriers\n"
           "ptxas info    : Compiling entry function '_ZN38_GLOBAL__N__d4e4be2d"
           "_6_msm_cu_f421cf8317msm_digits_kernelEPKl' for 'sm_90a'\n"
           "ptxas info    : Used 32 registers, used 0 barriers\n")
    assert kernels.ptxas_report(log) == [
        "_Z1aPi: 912 bytes stack frame, 3776 bytes spill stores, 3776 bytes "
        "spill loads", "_Z1aPi: Used 255 registers, used 0 barriers",
        "msm_digits_kernelEPKl: Used 32 registers, used 0 barriers"]


def test_kernel_build_of_named_sources(tmp_path):
    """kernels.build(sources=...) compiles and links the named sources
    alone (the fake nvcc writes its arguments as each output), and raises
    on a name csrc lacks."""
    from eigen_zkvm_tpu_torch import kernels

    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name in ("a.cu", "b.cu", "c.cu"):
        (csrc / name).write_text("#include <cstdint>\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    "a = sys.argv[1:]\n"
                    "open(a[a.index('-o') + 1], 'w').write(' '.join(a))\n")
    nvcc.chmod(0o755)
    info = kernels.build(False, str(csrc), str(out), str(nvcc),
                         sources=("c.cu", "a.cu"))
    assert info["compiled"] == ["a.cu", "c.cu"]
    link = (out / os.path.basename(kernels.LIB_PATH)).read_text()
    assert "a.cu.o" in link and "c.cu.o" in link and "b.cu.o" not in link
    assert not (out / "b.cu.o").exists()
    with pytest.raises(kernels.KernelError, match="d.cu"):
        kernels.build(False, str(csrc), str(out), str(nvcc),
                      sources=("a.cu", "d.cu"))


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
    assert all(kernels.counts()[k.name] > before[k.name]
               for k in (kernels.NTT, kernels.POSEIDON))   # the GL path's
    host_prove.stark_prove(*args, zkin_out=host_out)
    t2 = time.perf_counter()
    print(f"load + setup + prove + verify: port {t1 - t0:.3f} s, host "
          f"engine {t2 - t1:.3f} s")
    with open(port_out, "rb") as a, open(host_out, "rb") as b:
        port_json, host_json = a.read(), b.read()
    assert port_json == host_json
    digest = hashlib.sha256(host_json).hexdigest()
    assert digest == smoke.HOST_PROOF_SHA256, f"host engine's digest {digest}"
