"""The port's gnark bridge (eigen_zkvm_tpu_torch/recursion/{emulated,
pairing_circuit,gnark_bridge}.py, cli.py bls_wrap, bench_bridge.py) against
the JAX package's on the CPU, exactly (field arithmetic: tolerance 0).

Each circuit is built twice from the same seeded inputs, once with the JAX
package's modules and once with the port's, and the two builders' public
counts, wire counts, constraints (the {wire: coef} triples) and witnesses
must be equal, beside the values the gadgets return: the five cases of
tests/test_gnark_bridge.py, the pieces of the bridge (the fixed-base MSM
over one and two publics, G2 on-curve with the subgroup check, the residue
witness's host math) and bench_bridge.bridge_part, the part of the bridge
chip_smoke.py's phase 15 proves.  The bls_wrap command runs through both
CLIs on the same inner files with a small gadget circuit in place of the
verifier circuit (monkeypatch: the JAX package's files are not changed)
and `secrets.randbelow` one seeded draw in both: the same vk, proof and
public bytes, each package's verifier on the port's proof, a changed
public rejected, --reuse_setup reloading the port's key file.  The
full bridge's proof from the card (tests/data/bridge_card/) verifies in
both packages.

Slow: the full 7.8 M-constraint bridge built by both packages (a streamed
digest of each, one build in memory at a time), satisfied and binding; the
JAX host engine's Groth16 proof of bridge_part, whose sha256 is
chip_smoke.BRIDGE_PART_SHA256.  CUDA: bridge_part proved on the card to
that digest.
"""
import hashlib
import importlib.util
import os
import random
import secrets
from types import SimpleNamespace

import pytest
import torch

from eigen_zkvm_tpu import cli as jcli
from eigen_zkvm_tpu.curves import bls12_381 as jbls
from eigen_zkvm_tpu.curves import bn254 as jbn
from eigen_zkvm_tpu.groth16 import api as japi
from eigen_zkvm_tpu.groth16 import groth16 as jg
from eigen_zkvm_tpu.recursion import circuit as jcircuit
from eigen_zkvm_tpu.recursion import emulated as jemu
from eigen_zkvm_tpu.recursion import gnark_bridge as jgb
from eigen_zkvm_tpu.recursion import pairing_circuit as jpc
from eigen_zkvm_tpu_torch import bench_bridge as bb
from eigen_zkvm_tpu_torch import cli, kernels
from eigen_zkvm_tpu_torch.bench_groth16 import seeded
from eigen_zkvm_tpu_torch.curves import bls12_381 as bls
from eigen_zkvm_tpu_torch.curves import bn254 as bn
from eigen_zkvm_tpu_torch.groth16 import api
from eigen_zkvm_tpu_torch.groth16 import groth16 as g16
from eigen_zkvm_tpu_torch.recursion import circuit
from eigen_zkvm_tpu_torch.recursion import emulated as emu
from eigen_zkvm_tpu_torch.recursion import gnark_bridge as gb
from eigen_zkvm_tpu_torch.recursion import pairing_circuit as pcm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = SimpleNamespace(bn=jbn, bls=jbls, CB=jcircuit.CircuitBuilder,
                      emu=jemu, pc=jpc, gb=jgb)
PORT = SimpleNamespace(bn=bn, bls=bls, CB=circuit.CircuitBuilder, emu=emu,
                       pc=pcm, gb=gb)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain arithmetic issues many small tensor operations; intra-op
    threads only contend with the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _host_engine(monkeypatch):
    """The JAX package's host engine: it never probes for a TPU."""
    monkeypatch.setenv("EIGEN_ZKVM_ENGINE", "host")


def _same(build):
    """build(ns) -> (builder, values) with the JAX package's modules and with
    the port's: the same publics, wires, constraints, witness and values.
    Returns the port's (builder, values)."""
    jb, jv = build(JAX)
    b, v = build(PORT)
    assert (b.n_publics, b.n_vars, len(b.constraints)) == \
        (jb.n_publics, jb.n_vars, len(jb.constraints))
    assert b.constraints == jb.constraints
    assert b.w == jb.w
    assert v == jv
    return b, v


def _g1(ns, k):
    return ns.bn.g1_to_affine(ns.bn.g1_mul(ns.bn.g1_from_affine(
        ns.bn.G1_GEN), k))


def _g2(ns, k):
    return ns.bn.g2_to_affine(ns.bn.g2_mul(ns.bn.g2_from_affine(
        ns.bn.G2_GEN), k))


# ---- the five cases of tests/test_gnark_bridge.py ----

def test_emulated_field_ops():
    def build(ns):
        rng = random.Random(42)
        p = ns.bn.P
        b = ns.CB(prime=ns.bls.R)
        F = ns.emu.EmuField(b, p)
        xs = [rng.randrange(p) for _ in range(8)]
        es = [F.input(v) for v in xs]
        acc = F.new_acc()
        F.acc_mul(acc, es[0], es[1])
        F.acc_mul(acc, es[2], es[3], -1)
        F.acc_elem(acc, es[4], 3)
        vals = [F.val(F.mul(es[0], es[1])), F.val(F.reduce(acc)),
                F.val(F.div(es[5], es[6]))]
        F.assert_eq(F.add(es[0], es[1]), F.add(es[1], es[0]))
        assert vals == [xs[0] * xs[1] % p,
                        (xs[0] * xs[1] - xs[2] * xs[3] + 3 * xs[4]) % p,
                        xs[5] * pow(xs[6], -1, p) % p]
        return b, vals

    b, _ = _same(build)
    assert b.check()
    # tampering any emulated witness value must break satisfaction
    b.w[5] = (b.w[5] + 1) % bls.R
    assert not b.check()


def test_fq12_tower_and_frobenius():
    def build(ns):
        rng = random.Random(11)
        a = ns.pc.unflat12([rng.randrange(ns.bn.P) for _ in range(12)])
        c = ns.pc.unflat12([rng.randrange(ns.bn.P) for _ in range(12)])
        b = ns.CB(prime=ns.bls.R)
        pc = ns.pc.PairingCircuit(b)
        ea, ec = pc.f12_input(a), pc.f12_input(c)
        vals = [pc.f12_val(pc.f12_mul(ea, ec)), pc.f12_val(pc.f12_sq(ea)),
                pc.f12_val(pc.f12_frobenius(ea, ns.pc.FROB1)),
                pc.f12_val(pc.f12_frobenius(ea, ns.pc.FROB2))]
        assert vals == [ns.bn.f12_mul(a, c), ns.bn.f12_mul(a, a),
                        ns.bn.f12_frobenius(a),
                        ns.bn.f12_frobenius(ns.bn.f12_frobenius(a))]
        return b, vals

    b, _ = _same(build)
    assert pcm.TABLE12 == jpc.TABLE12
    assert (pcm.FROB1, pcm.FROB2, pcm.FROB3) == (jpc.FROB1, jpc.FROB2,
                                                 jpc.FROB3)
    assert b.check()


def test_point_gadgets_match_value_impl():
    def build(ns):
        rng = random.Random(7)
        b = ns.CB(prime=ns.bls.R)
        pc = ns.pc.PairingCircuit(b)
        Qa = _g2(ns, rng.randrange(ns.bn.R))
        eq = pc.g2_input(Qa)
        pc.g2_assert_on_curve(eq)
        T2, _, _ = pc.g2_double(eq)
        T3, _, _ = pc.g2_add(T2, eq)
        Pa, Pb = _g1(ns, rng.randrange(ns.bn.R)), _g1(ns, rng.randrange(
            ns.bn.R))
        ep, ep2 = pc.g1_input(Pa), pc.g1_input(Pb)
        pc.g1_assert_on_curve(ep)
        ws = ns.pc.one_hot_w27(pc, 5)
        vals = [pc.g2_val(T2), pc.g2_val(T3), pc.g1_val(pc.g1_add(ep, ep2)),
                [0 if x is None else pc.F.val(x) for x in ws]]
        bnm = ns.bn
        assert vals == [
            bnm.g2_to_affine(bnm.g2_double(bnm.g2_from_affine(Qa))),
            bnm.g2_to_affine(bnm.g2_add(bnm.g2_from_affine(vals[0]),
                                        bnm.g2_from_affine(Qa))),
            bnm.g1_to_affine(bnm.g1_add(bnm.g1_from_affine(Pa),
                                        bnm.g1_from_affine(Pb))),
            ns.pc.flat12(bnm.f12_pow(ns.pc.w27_constant(), 5))]
        return b, vals

    b, _ = _same(build)
    assert b.check()


def test_residue_witness_host_math():
    """Completeness + rejection of the residue construction (the in-circuit
    final-exp replacement; 'On Proving Pairings', Novakovic-Eagen 2024), on
    the port's curve module (bn.g2_neg among its new functions), the same
    witness as the JAX package's."""
    rng = random.Random(3)
    a, c = rng.randrange(1, bn.R), rng.randrange(1, bn.R)
    P1, Q1 = _g1(PORT, a), _g2(PORT, c)
    P2 = _g1(PORT, a * c % bn.R)
    Q2n = bn.g2_to_affine(bn.g2_neg(bn.g2_from_affine(bn.G2_GEN)))
    assert Q2n == jbn.g2_to_affine(jbn.g2_neg(jbn.g2_from_affine(
        jbn.G2_GEN)))
    assert all(bn.g1_is_on_curve(p) for p in (P1, P2, None))
    assert all(bn.g2_is_on_curve(q) for q in (Q1, Q2n, None))
    assert not bn.g1_is_on_curve((P1[0], P1[1] + 1))
    assert not bn.g2_is_on_curve((Q1[0], (Q1[1][0] + 1, Q1[1][1])))
    assert bn.B2 == jbn.B2
    f = bn.f12_mul(bn.miller_loop(P1, Q1), bn.miller_loop(P2, Q2n))
    cw, j = pcm.residue_witness(f)
    assert (cw, j) == jpc.residue_witness(f)
    assert pcm.w27_constant() == jpc.w27_constant()
    w = bn.f12_pow(pcm.w27_constant(), j)
    assert bn.f12_mul(f, w) == bn.f12_pow(cw, pcm.LAMBDA)
    # an invalid pairing product has no residue witness
    bad = bn.f12_mul(f, bn.pairing(bn.G1_GEN, bn.G2_GEN))
    with pytest.raises(ValueError):
        pcm.residue_witness(bad)


_INNER: dict = {}


def _inner():
    """The toy inner proof (bench_bridge.toy_inner) on the CPU, and the JAX
    package's proof of the same circuit with the same draws."""
    if not _INNER:
        vk, proof, pubs = bb.toy_inner("cpu")
        jb = jcircuit.CircuitBuilder(prime=jbn.R)
        out1, out2 = jb.public(35), jb.public(12)
        x, y = jb.wire(jb.sig(5)), jb.wire(jb.sig(7))
        jb.assert_eq(jb.mul(x, y), out1)
        jb.assert_eq(x + y, out2)
        jpk, jvk = jg.setup(jbn, jb.constraints, jb.n_vars, jb.n_publics,
                            rng=seeded(bb.INNER_SEED))
        jproof, jpubs = jg.prove(jbn, jpk, jb.constraints, jb.w,
                                 rng=seeded(bb.INNER_SEED + 1))
        _INNER.update(port=(vk, proof, pubs), jax=(jvk, jproof, jpubs))
    return _INNER


def test_toy_inner_proof_is_the_jax_packages():
    inner = _inner()
    (vk, proof, pubs), (jvk, jproof, jpubs) = inner["port"], inner["jax"]
    assert pubs == jpubs == [35, 12]
    assert api.vk_to_json(vk) == japi.vk_to_json(jvk)
    assert api.proof_to_json(proof, "bn128") == \
        japi.proof_to_json(jproof, "bn128")
    assert jg.verify(jbn, jvk, jproof, jpubs)


def test_forged_inner_proofs_are_rejected_before_any_constraint():
    """The full case's rejections (tests/test_gnark_bridge.py's forged C and
    forged public): both packages raise in the host residue witness."""
    vk, proof, pubs = _inner()["port"]
    bad = g16.Proof(a=proof.a, b=proof.b,
                    c=bn.g1_to_affine(bn.g1_double(bn.g1_from_affine(
                        proof.c))))
    for ns in (JAX, PORT):
        with pytest.raises(ValueError):
            ns.gb.build_verifier_circuit(vk, bad, pubs)
        with pytest.raises((ValueError, AssertionError)):
            ns.gb.build_verifier_circuit(vk, proof, [pubs[0],
                                                     (pubs[1] + 1) % bn.R])


def _constraints_digest(b) -> str:
    """sha256 over a builder's sizes, each constraint's three {wire: coef}
    maps (sorted) and its witness, in chunks: one build's worth of
    memory."""
    h = hashlib.sha256(repr((b.n_publics, b.n_vars,
                             len(b.constraints))).encode())
    step = 1 << 16
    for i in range(0, len(b.constraints), step):
        h.update(repr([tuple(sorted(d.items())) for row in
                       b.constraints[i:i + step] for d in row]).encode())
    for i in range(0, len(b.w), step):
        h.update(repr(b.w[i:i + step]).encode())
    return h.hexdigest()


@pytest.mark.slow
def test_bridge_circuit_satisfied_and_binding():
    """Full wrap circuit (about 7.84 M constraints, domain 2^23): the JAX
    package's and the port's builds of the toy inner proof's verifier have
    the same constraints and witness (streamed digests, one build alive at
    a time), the port's is satisfied, a forged C and a forged public are
    rejected, a tampered witness value fails the R1CS."""
    import gc

    vk, proof, pubs = _inner()["port"]
    jb = jgb.build_verifier_circuit(vk, proof, pubs)
    jd = _constraints_digest(jb)
    n = len(jb.constraints)
    del jb
    gc.collect()
    b = gb.build_verifier_circuit(vk, proof, pubs)
    assert len(b.constraints) == n
    assert _constraints_digest(b) == jd
    assert b.n_publics == len(pubs)
    assert b.check()
    k = len(b.w) // 2
    b.w[k] = (b.w[k] + 1) % bls.R
    assert not b.check()
    print(f"bridge circuit: {n} constraints, {b.n_vars} wires")
    del b
    bad = g16.Proof(a=proof.a, b=proof.b,
                    c=bn.g1_to_affine(bn.g1_double(bn.g1_from_affine(
                        proof.c))))
    with pytest.raises(ValueError):
        gb.build_verifier_circuit(vk, bad, pubs)
    with pytest.raises((ValueError, AssertionError)):
        gb.build_verifier_circuit(vk, proof, [pubs[0], (pubs[1] + 1) % bn.R])


# ---- the pieces ----

@pytest.mark.parametrize("n_pub", [1, 2])
def test_msm_fixed_base_matches_the_jax_builder(n_pub):
    rng = random.Random(17 + n_pub)
    ks = [rng.randrange(1, bn.R) for _ in range(n_pub + 1)]
    vals = [rng.randrange(bn.R) for _ in range(n_pub - 1)] + [bn.R - 1]

    def build(ns):
        b = ns.CB(prime=ns.bls.R)
        ic = [_g1(ns, k) for k in ks]
        wires = [b.public(v) for v in vals]
        pc = ns.pc.PairingCircuit(b)
        out = pc.g1_val(ns.gb._msm_fixed_base(pc, ic, wires, vals))
        return b, out

    b, out = _same(build)
    acc = bn.g1_from_affine(_g1(PORT, ks[0]))
    for k, v in zip(ks[1:], vals):
        acc = bn.g1_add(acc, bn.g1_mul(bn.g1_from_affine(_g1(PORT, k)), v))
    assert out == bn.g1_to_affine(acc)
    assert gb._H_POINT == jgb._H_POINT and gb._NWIN == jgb._NWIN == 64
    if n_pub == 1:
        assert b.check()


def test_g2_on_curve_and_subgroup_check_match_the_jax_builder():
    Q = _g2(PORT, random.Random(23).randrange(1, bn.R))

    def build(ns):
        b = ns.CB(prime=ns.bls.R)
        pc = ns.pc.PairingCircuit(b)
        B = pc.g2_input(Q)
        pc.g2_assert_on_curve(B)
        pc.g2_assert_in_subgroup(B)
        return b, pc.g2_val(B)

    b, val = _same(build)
    assert val == Q
    assert b.check()


def test_bridge_part_is_the_jax_composition():
    """bench_bridge.bridge_part (phase 15's circuit) equals the same calls
    made with the JAX package's modules; satisfied; a changed witness value
    breaks it."""
    vk, proof, pubs = _inner()["port"]

    def build(ns):
        if ns is PORT:
            return bb.bridge_part(vk, proof, pubs), None
        return _jax_bridge_part(vk, proof, pubs), None

    b, _ = _same(build)
    assert len(b.constraints) == _smoke().BRIDGE_PART_CONSTRAINTS
    assert b.check()
    b.w[len(b.w) // 3] = (b.w[len(b.w) // 3] + 1) % bls.R
    assert not b.check()


def _miller_product(vk, proof, pub_vals):
    """The JAX package's verifier product (gnark_bridge.py:149-157)."""
    neg = lambda p: (p[0], (-p[1]) % jbn.P)  # noqa: E731
    acc = jbn.g1_from_affine(vk.ic[0])
    for v, pt in zip(pub_vals, vk.ic[1:]):
        acc = jbn.g1_add(acc, jbn.g1_mul(jbn.g1_from_affine(pt), v))
    f = jbn.miller_loop(proof.a, proof.b)
    f = jbn.f12_mul(f, jbn.miller_loop(neg(jbn.g1_to_affine(acc)),
                                       vk.gamma2))
    f = jbn.f12_mul(f, jbn.miller_loop(neg(proof.c), vk.delta2))
    return jbn.f12_mul(f, jbn.miller_loop(neg(vk.alpha1), vk.beta2))


# ---- bls_wrap through both CLIs ----

def _gadget(ns):
    """A small stand-in for build_verifier_circuit over ns's modules: the
    inner publics re-exposed and squared, the inner A's x as emulated limbs
    (a few constraints: the CPU's plain BLS12-381 arithmetic is slow)."""
    def build(vk, proof, publics, record=True):
        b = ns.CB(record=record, prime=ns.bls.R)
        vals = [int(v) % ns.bn.R for v in publics]
        wires = [b.public(v) for v in vals]
        for v, w in zip(vals, wires):
            b.assert_eq(b.mul(w, w), b.wire(b.sig(v * v % ns.bls.R)))
        ns.pc.PairingCircuit(b).F.input(proof.a[0], check=False)
        return b
    return build


def _patch_draws(monkeypatch, seed):
    rng = random.Random(seed)
    monkeypatch.setattr(secrets, "randbelow", lambda n: rng.randrange(n))


def test_bls_wrap_cli_matches_the_jax_cli(monkeypatch, tmp_path):
    """bls_wrap through both CLIs, secrets.randbelow one seeded draw in
    both: the port's run with --reuse_setup writes the JAX CLI's vk, proof
    and public bytes and keeps its key file; both verifiers accept the
    port's proof and reject a changed public; a second run reloads the key
    and proves again."""
    vk, proof, pubs = _inner()["port"]
    inner = tmp_path / "inner"
    inner.mkdir()
    bb.write_inner(str(inner), vk, proof, pubs)
    monkeypatch.setattr(jgb, "build_verifier_circuit", _gadget(JAX))
    monkeypatch.setattr(gb, "build_verifier_circuit", _gadget(PORT))
    args = ["bls_wrap", "--vk", str(inner / "vk.json"), "--proof",
            str(inner / "proof.json"), "--public_input",
            str(inner / "public.json")]
    names = ("wrap_vk.json", "wrap_proof.json", "wrap_public.json")
    out = {}
    for side in ("jax", "port"):
        d = str(tmp_path / side)
        _patch_draws(monkeypatch, 31)
        if side == "jax":
            jcli.main(args + ["--output_dir", d])
        else:
            assert cli.main(args + ["--output_dir", d, "--device", "cpu",
                                    "--reuse_setup"]) == 0
        out[side] = {}
        for k in names:
            with open(os.path.join(d, k)) as f:
                out[side][k] = f.read()
    assert out["port"] == out["jax"]
    vk_text, proof_text, pub_text = (out["port"][k] for k in names)
    ovk = api.vk_from_json(vk_text)
    oproof = api.proof_from_json(proof_text)
    opubs = api.publics_from_json(pub_text)
    assert ovk.curve_name == "bls12381" and opubs == pubs
    changed = [opubs[0] + 1] + opubs[1:]
    for pubs_, ok in ((opubs, True), (changed, False)):
        assert g16.verify(ovk, oproof, pubs_) == ok
        assert jg.verify(jbls, japi.vk_from_json(vk_text),
                         japi.proof_from_json(proof_text), pubs_) == ok

    # --reuse_setup: the key file kept by the run above is reloaded and
    # proves again (other draws), to the same vk
    d = str(tmp_path / "port")
    assert api.load_pk(os.path.join(d, "wrap_pk.bin"), "cpu").curve_name \
        == "bls12381"
    assert cli.main(args + ["--output_dir", d, "--device", "cpu",
                            "--reuse_setup"], rng=seeded(6)) == 0
    with open(os.path.join(d, "wrap_vk.json")) as f:
        assert f.read() == vk_text
    with open(os.path.join(d, "wrap_proof.json")) as f:
        again = api.proof_from_json(f.read())
    assert again != oproof
    assert g16.verify(ovk, again, pubs)
    # a BLS12-381 vk is not an inner (BN254) key
    with pytest.raises(ValueError, match="bls12381 key"):
        cli.main(["bls_wrap", "--vk", os.path.join(d, "wrap_vk.json"),
                  *args[3:], "--output_dir", d, "--device", "cpu"])


def test_wrap_proof_matches_the_jax_wrap_proof(monkeypatch):
    """gnark_bridge.wrap_proof with the gadget circuit: the JAX package's
    wrap_proof with the same draws gives the same vk and proof."""
    vk, proof, pubs = _inner()["port"]
    monkeypatch.setattr(jgb, "build_verifier_circuit", _gadget(JAX))
    monkeypatch.setattr(gb, "build_verifier_circuit", _gadget(PORT))
    _patch_draws(monkeypatch, 37)
    _, jvk, jproof, jpubs = jgb.wrap_proof(vk, proof, pubs)
    _patch_draws(monkeypatch, 37)
    pk, ovk, oproof, opubs = gb.wrap_proof(vk, proof, pubs, device="cpu")
    assert pk.curve_name == "bls12381" and opubs == jpubs == pubs
    assert api.vk_to_json(ovk) == japi.vk_to_json(jvk)
    assert api.proof_to_json(oproof, "bls12381") == \
        japi.proof_to_json(jproof, "bls12381")


def test_the_full_bridge_proof_from_the_card_verifies_in_both_packages():
    """tests/data/bridge_card/: the outer vk, proof and public JSON that
    bench_bridge printed for the full 7,841,774-constraint bridge of
    toy_inner's proof, proved through bls_wrap on an H100: each package's
    verifier accepts it and rejects a changed public."""
    d = os.path.join(ROOT, "tests", "data", "bridge_card")
    texts = {}
    for k in ("wrap_vk.json", "wrap_proof.json", "wrap_public.json"):
        with open(os.path.join(d, k)) as f:
            texts[k] = f.read()
    ovk = api.vk_from_json(texts["wrap_vk.json"])
    oproof = api.proof_from_json(texts["wrap_proof.json"])
    opubs = api.publics_from_json(texts["wrap_public.json"])
    assert ovk.curve_name == "bls12381" and opubs == [35, 12]
    jvk = japi.vk_from_json(texts["wrap_vk.json"])
    jproof = japi.proof_from_json(texts["wrap_proof.json"])
    for pubs_, ok in ((opubs, True), ([36, 12], False)):
        assert g16.verify(ovk, oproof, pubs_) == ok
        assert jg.verify(jbls, jvk, jproof, pubs_) == ok


# ---- the digest chip_smoke.py's phase 15 holds ----

def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_bridge_part_on_the_card_matches_the_pinned_digest():
    """bridge_part of the toy inner proof, set up and proved by the port on
    the card: its BLS12-381 kernels launch, and the proof's sha256 is
    chip_smoke.BRIDGE_PART_SHA256."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    smoke = _smoke()
    circ = bb.bridge_part(*bb.toy_inner())
    kernels.reset_counts()
    pk, vk = api.groth16_setup_inplace("bls12381", circ,
                                       rng=seeded(bb.OUTER_SEED))
    proof, pubs = api.groth16_prove_inplace("bls12381", circ, pk,
                                            rng=seeded(bb.OUTER_SEED + 1))
    assert all(kernels.counts()[k.name] > 0 for k in (
        kernels.MSM_BLS, kernels.EC_BATCH_BLS, kernels.FR_NTT_BLS,
        kernels.R1CS_BLS))
    text = api.proof_to_json(proof, "bls12381")
    assert hashlib.sha256(text.encode()).hexdigest() == \
        smoke.BRIDGE_PART_SHA256
    assert api.groth16_verify_inplace("bls12381", vk, proof, pubs)


@pytest.mark.slow
def test_host_engine_gives_the_pinned_bridge_part_digest():
    """The JAX package's host engine (native.ec_bls12381) on bridge_part's
    circuit, built from the JAX modules, with phase 15's draws: the proof
    JSON's sha256 is chip_smoke.BRIDGE_PART_SHA256 (printed, to pin a new
    one)."""
    smoke = _smoke()
    jvk, jproof, jpubs = _inner()["jax"]
    circ = bb.bridge_part(jvk, jproof, jpubs)
    jb = _jax_bridge_part(jvk, jproof, jpubs)
    assert jb.constraints == circ.constraints and jb.w == circ.w
    del circ
    jpk, ovk = jg.setup(jbls, jb.constraints, jb.n_vars, jb.n_publics,
                        rng=seeded(bb.OUTER_SEED))
    oproof, opubs = jg.prove(jbls, jpk, jb.constraints, jb.w,
                             rng=seeded(bb.OUTER_SEED + 1))
    assert jg.verify(jbls, ovk, oproof, opubs)
    digest = hashlib.sha256(japi.proof_to_json(
        oproof, "bls12381").encode()).hexdigest()
    print(f"BRIDGE_PART_SHA256 = {digest} ({len(jb.constraints)} "
          f"constraints)")
    assert digest == smoke.BRIDGE_PART_SHA256


def _jax_bridge_part(vk, proof, pubs):
    """bridge_part's calls made with the JAX package's modules."""
    b = jcircuit.CircuitBuilder(prime=jbls.R)
    pub_vals = [int(x) % jbn.R for x in pubs]
    pub_wires = [b.public(v) for v in pub_vals]
    pc = jpc.PairingCircuit(b)
    A = pc.g1_input(proof.a)
    pc.g2_input(proof.b)
    C = pc.g1_input(proof.c)
    pc.g1_assert_on_curve(A)
    pc.g1_assert_on_curve(C)
    jgb._msm_fixed_base(pc, vk.ic, pub_wires, pub_vals)
    c_val, _ = jpc.residue_witness(_miller_product(vk, proof, pub_vals))
    pc.f12_mul_assert_const(pc.f12_input(c_val),
                            pc.f12_input(jbn.f12_inv(c_val)), jbn.F12_ONE)
    return b
