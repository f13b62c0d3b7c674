"""Native gnark-bridge equivalent: verify a BN254 Groth16 proof inside a
BLS12-381 R1CS circuit, then prove THAT circuit with BLS12-381 Groth16.

Reference capability: recursion-gnark/ffi/go/eigen/recursion.go:30-82
(`VerifyBN254InBLS12381` — gnark emulated pairing verifier) driven through
recursion-gnark/ffi/src/ffi/native.rs:32.  Here the same wrap is built with
the in-repo circuit builder: the inner verifying key is baked into the
circuit as constants (fixed-G2 Miller lines, constant miller(-alpha, beta)),
the inner proof (A, B, C) is private witness, and the inner public inputs
are re-exposed as the outer proof's public inputs.

The verification equation mirrors groth16/groth16.py:428 exactly:
    e(A, B) * e(-alpha, beta) * e(-IC(pub), gamma) * e(-C, delta) == 1
checked as one shared Miller product with a residue witness instead of a
final exponentiation (see recursion/pairing_circuit.py).

Soundness extras over the bare equation: A and C are constrained on-curve
(G1 has cofactor 1), B is constrained on-curve AND in the G2 subgroup
(psi(B) == [6x^2]B), and each public scalar is range-checked below the
BN254 group order.

Port of eigen_zkvm_tpu/recursion/gnark_bridge.py: the same circuit,
constraint for constraint, on the port's builder and curves; the host-side
residue witness is `inner_residue` (shared with bench_bridge.bridge_part),
and `wrap_proof` proves with the port's curve-generic Groth16 on the card.
"""
from __future__ import annotations

from ..curves import bn254 as bn
from ..curves import bls12_381 as bls
from .circuit import CircuitBuilder
from .emulated import _bits_fast, _lc_sum
from .pairing_circuit import (PairingCircuit, precompute_lines,
                              miller_loop_and_residue_check, one_hot_w27,
                              residue_witness)

# nothing-up-my-sleeve blinder base for the fixed-base public-input MSM
_H_SCALAR = int.from_bytes(b"eigen-zkvm-tpu gnark bridge H", "big") % bn.R
_H_POINT = bn.g1_to_affine(bn.g1_mul(bn.g1_from_affine(bn.G1_GEN), _H_SCALAR))

_WINDOW = 4
_NWIN = (bn.R.bit_length() + _WINDOW - 1) // _WINDOW  # 64 windows of 4 bits


def _msm_fixed_base(pc: PairingCircuit, ic_points, pub_wires, pub_values):
    """L = IC[0] + sum_i pub_i * IC[i+1] with constant bases.

    Each 4-bit window selects one of 16 CONSTANT table points (selection is
    a free linear combination over one-hot selectors), every table entry is
    offset by a distinct blinder multiple of H so no entry or honest partial
    sum is the identity, and the accumulated blinder (a constant) is
    subtracted at the end.  Incomplete affine additions: an equal-x pair
    aborts witness generation (probability ~2^-240 for honest inputs)."""
    b = pc.b
    Wc = b.W
    acc = pc.g1_const(ic_points[0])
    blinder = 0
    for i, (w, v) in enumerate(zip(pub_wires, pub_values)):
        # range check: v < r_bn  (v + 2^254 - r < 2^254); the window bits
        # below additionally bind w to a 256-bit decomposition
        shift = (1 << 254) - bn.R
        _bits_fast(b, w + Wc(k=shift), v + shift, 254)
        base = bn.g1_from_affine(ic_points[i + 1])
        h = bn.g1_from_affine(_H_POINT)
        bits = []
        for t in range(_NWIN):
            jv = (v >> (t * _WINDOW)) & (2 ** _WINDOW - 1)
            # one-hot selectors from 4 fresh bits bound to the window value
            wbits = []
            for u in range(_WINDOW):
                bit = (jv >> u) & 1
                s = b.sig(bit)
                bw = b.wire(s)
                if b.record:
                    b.constraints.append(({s: 1}, {s: 1, 0: b.P - 1}, {}))
                wbits.append(bw)
            bits.append((wbits, jv))
        # bind the window bits to the public wire
        recomposed = _lc_sum(
            Wc, [(bw, 1 << (t * _WINDOW + u))
                 for t, (wbits, _) in enumerate(bits)
                 for u, bw in enumerate(wbits)])
        b.assert_zero(recomposed - w)
        for t, (wbits, jv) in enumerate(bits):
            d = i * _NWIN + t + 1
            blinder = (blinder + d) % bn.R
            dh = bn.g1_mul(h, d)
            table = []
            for jj in range(16):
                pt = bn.g1_to_affine(
                    bn.g1_add(bn.g1_mul(base, (jj << (t * _WINDOW)) % bn.R),
                              dh))
                table.append(pt)
            # one-hot: l1 over low 2 bits, l2 over high 2 bits
            l1 = _two_bit_onehot(b, wbits[0], wbits[1], jv & 3)
            l2 = _two_bit_onehot(b, wbits[2], wbits[3], jv >> 2)
            sels = []
            for jj in range(16):
                sw = b.mul(l1[jj & 3], l2[jj >> 2])
                sels.append(sw)
            sel_pt = _select_const_g1(pc, sels, table, jv)
            acc = pc.g1_add(acc, sel_pt)
    # subtract total blinder
    neg_bl = bn.g1_to_affine(bn.g1_neg(bn.g1_mul(
        bn.g1_from_affine(_H_POINT), blinder)))
    acc = pc.g1_add(acc, pc.g1_const(neg_bl))
    return acc


def _two_bit_onehot(b, b0, b1, v):
    """[(1-b0)(1-b1), b0(1-b1), (1-b0)b1, b0 b1] (3 multiplications)."""
    one = b.W(k=1)
    p11 = b.mul(b0, b1)
    p10 = b0 - p11
    p01 = b1 - p11
    p00 = one - b0 - p01
    return [p00, p10, p01, p11]


def _select_const_g1(pc, sels, table, jv):
    """sum_j sel_j * table_j as a G1 point of lc-limbed elements (free)."""
    from .emulated import EmuElem
    F = pc.F
    Wc = pc.b.W
    out = []
    for coord in range(2):
        limbs_ws, ivals, his = [], [0] * F.L, [0] * F.L
        for l in range(F.L):
            terms = []
            for j, sw in enumerate(sels):
                limb = (table[j][coord] >> (F.lb * l)) & F.mask
                if limb:
                    terms.append((sw, limb))
                    his[l] += limb
                if j == jv:
                    ivals[l] = limb
            limbs_ws.append(_lc_sum(Wc, terms))
        out.append(EmuElem(limbs_ws, ivals, [0] * F.L, his))
    return (out[0], out[1])


def inner_residue(vk, proof, pub_vals):
    """The verifier's host values for an inner proof and its publics (ints
    below r): (IC(pub) affine, miller(-alpha, beta), the residue witness c
    and its mu27 index).  Raises ValueError if the proof does not verify."""
    neg = lambda p: (p[0], (-p[1]) % bn.P)
    ic_acc = bn.g1_from_affine(vk.ic[0])
    for v, pt in zip(pub_vals, vk.ic[1:]):
        ic_acc = bn.g1_add(ic_acc, bn.g1_mul(bn.g1_from_affine(pt), v))
    ic_val = bn.g1_to_affine(ic_acc)
    f = bn.miller_loop(proof.a, proof.b)
    f = bn.f12_mul(f, bn.miller_loop(neg(ic_val), vk.gamma2))
    f = bn.f12_mul(f, bn.miller_loop(neg(proof.c), vk.delta2))
    m_ab = bn.miller_loop(neg(vk.alpha1), vk.beta2)
    f = bn.f12_mul(f, m_ab)
    c_val, j27 = residue_witness(f)       # raises if the proof is invalid
    return ic_val, m_ab, c_val, j27


def build_verifier_circuit(vk, proof, publics, record: bool = True
                           ) -> CircuitBuilder:
    """Build (and witness) the BN254-Groth16-verifier circuit over
    BLS12-381 Fr.  Raises if the inner proof does not verify."""
    b = CircuitBuilder(record=record, prime=bls.R)
    pub_vals = [int(x) % bn.R for x in publics]

    # host-side residue witness FIRST: an invalid inner proof raises here
    # in milliseconds, before any constraints are built
    ic_val, m_ab, c_val, j27 = inner_residue(vk, proof, pub_vals)

    pub_wires = [b.public(v) for v in pub_vals]
    pc = PairingCircuit(b)
    A = pc.g1_input(proof.a)
    B = pc.g2_input(proof.b)
    C = pc.g1_input(proof.c)
    pc.g1_assert_on_curve(A)
    pc.g1_assert_on_curve(C)
    pc.g2_assert_on_curve(B)
    pc.g2_assert_in_subgroup(B)

    ic = _msm_fixed_base(pc, vk.ic, pub_wires, pub_vals)
    assert pc.g1_val(ic) == ic_val
    neg_ic = pc.g1_neg(ic)
    neg_c = pc.g1_neg(C)

    c_elem = pc.f12_input(c_val)
    c_inv_elem = pc.f12_input(bn.f12_inv(c_val))
    pc.f12_mul_assert_const(c_elem, c_inv_elem, bn.F12_ONE)
    w_sel = one_hot_w27(pc, j27)

    lines_gamma = precompute_lines(vk.gamma2)
    lines_delta = precompute_lines(vk.delta2)
    miller_loop_and_residue_check(
        pc, (A, B), [(neg_ic, lines_gamma), (neg_c, lines_delta)],
        m_ab, c_elem, c_inv_elem, w_sel)
    return b


def wrap_proof(inner_vk, inner_proof, inner_publics, outer_setup=None,
               device=None, prof=None, rng=None):
    """Produce a BLS12-381 Groth16 proof attesting the BN254 proof verifies.

    Returns (outer_pk, outer_vk, outer_proof, outer_publics); pass
    `outer_setup=(pk, vk)` to reuse a previous setup for the same inner vk.
    Setup and prove run on `device` (None: the current CUDA device, raising
    without one; "cpu" runs the kernels' plain versions; a reused key
    proves where its queries are), tick `prof` (utils/profiler.Prof) and
    draw from `rng` (None: `secrets`), setup first.
    """
    from ..groth16 import groth16 as core
    from ..utils.profiler import Prof

    dev = core.resolve_device(device) if outer_setup is None else \
        outer_setup[0].a_query.device
    prof = prof or Prof("gnark_bridge.wrap_proof", dev)
    b = build_verifier_circuit(inner_vk, inner_proof, inner_publics)
    prof.tick("build")
    if outer_setup is None:
        pk, vk = core.setup(b.constraints, b.n_vars, b.n_publics, rng=rng,
                            device=dev, prof=prof, curve="bls12381")
    else:
        pk, vk = outer_setup
    outer_proof, outer_pubs = core.prove(pk, b.constraints, b.w, rng=rng,
                                         prof=prof)
    return pk, vk, outer_proof, outer_pubs
