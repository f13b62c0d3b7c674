"""On-chain STARK verifier circuit over the snark field (BN254/BLS12-381).

The native equivalent of the reference's rendered circom verifier for
BN128/BLS12381-hash proofs (starky/src/stark_verifier_circom_onchain.rs):
Goldilocks arithmetic emulated in Fr (gl_in_fr.py), big-field Poseidon
transcript and 16-ary Merkle trees, and a Main whose single public signal
is sha256(proverAddr_160 || publics_64each) — the exact on-chain interface
(onchain renderer :1786-1814).  The resulting R1CS + witness feed Groth16
directly (groth16/groth16.py), replacing the circom->wasm->bellman loop.

Port of eigen_zkvm_tpu/recursion/stark_verifier_circuit_bn.py over the
port's starkinfo (stark/starkinfo.py) and ops/gl.py int helpers; the snark
field's r is an argument (`curve_r`: BN254's, curves/bn254.R, by default,
or BLS12-381's, ops/bigint.FR_BLS.modulus).
"""
from __future__ import annotations

import hashlib

from ..curves import bn254
from ..ops import gl as gl64mod
from ..stark.types import parse_pil_number
from .circuit import CircuitBuilder
from .gl_in_fr import (GlCircuit, GlF, PoseidonFrCircuit,
                       TranscriptBigCircuit, _assert_lt_const, sha256_bits,
                       GL_P)


def _root(k: int) -> int:
    return gl64mod.root_of_unity(k)


class ProofSignalsBN:
    """All signals of one big-field proof (zkin schema for BN128/BLS hash
    types: roots and siblings are single Fr values, 16 siblings/level)."""

    def __init__(self, b: CircuitBuilder, gl: GlCircuit, zkin: dict,
                 starkinfo, ss):
        sN = starkinfo.map_sectionsN

        def fr_sig(v):
            return b.wire(b.sig(int(v)))

        self.root1 = fr_sig(zkin["root1"])
        self.root2 = fr_sig(zkin["root2"])
        self.root3 = fr_sig(zkin["root3"])
        self.root4 = fr_sig(zkin["root4"])
        self.evals = [gl.f3_input(e) for e in zkin["evals"]]
        nq = ss.nQueries
        widths = {"1": sN.get("cm1_2ns"), "2": sN.get("cm2_2ns"),
                  "3": sN.get("cm3_2ns"), "4": sN.get("cm4_2ns"),
                  "C": starkinfo.n_constants}
        self.s0_vals = {}
        self.s0_sibs = {}
        for name in ("1", "2", "3", "4", "C"):
            if widths[name] == 0:
                continue
            self.s0_vals[name] = [
                [gl.input64(v) for v in zkin[f"s0_vals{name}"][q]]
                for q in range(nq)]
            self.s0_sibs[name] = [
                [[fr_sig(x) for x in lvl]
                 for lvl in zkin[f"s0_siblings{name}"][q]]
                for q in range(nq)]
        self.s_root = {}
        self.s_vals = {}
        self.s_sibs = {}
        for s in range(1, len(ss.steps)):
            self.s_root[s] = fr_sig(zkin[f"s{s}_root"])
            self.s_vals[s] = [[gl.input64(v) for v in zkin[f"s{s}_vals"][q]]
                              for q in range(nq)]
            self.s_sibs[s] = [[[fr_sig(x) for x in lvl]
                               for lvl in zkin[f"s{s}_siblings"][q]]
                              for q in range(nq)]
        self.final_pol = [gl.f3_input(e) for e in zkin["finalPol"]]


def _unroll_code_bn(gl: GlCircuit, code, refs):
    """verifier code over GlF triples (onchain unrollCode analog)."""
    tmp = {}

    def get_ref(r):
        t = r.type_
        if t == "tmp":
            return tmp[r.id]
        if t in ("tree1", "tree2", "tree3", "tree4"):
            vals = refs[t]
            if r.dim == 1:
                return (vals[r.tree_pos], gl.const(0), gl.const(0))
            return tuple(vals[r.tree_pos + e] for e in range(3))
        if t == "const":
            return (refs["consts"][r.id], gl.const(0), gl.const(0))
        if t == "eval":
            return refs["evals"][r.id]
        if t == "number":
            return gl.f3_const(parse_pil_number(r.value))
        if t == "public":
            v = refs["publics"][r.id]
            return (v, gl.const(0), gl.const(0)) if isinstance(v, GlF) else v
        if t == "challenge":
            return refs["challenges"][r.id]
        if t == "x":
            return refs["challenges"][7]
        if t == "Z":
            return refs["Zp" if r.prime else "Z"]
        if t == "xDivXSubXi":
            return refs["xDivXSubXi"]
        if t == "xDivXSubWXi":
            return refs["xDivXSubWXi"]
        raise ValueError(f"Invalid ref type {t}")

    for ci in code:
        src = [get_ref(s) for s in ci.src]
        if ci.op == "add":
            res = gl.f3_add(src[0], src[1])
        elif ci.op == "sub":
            res = gl.f3_sub(src[0], src[1])
        elif ci.op == "mul":
            res = gl.f3_mul(src[0], src[1])
        elif ci.op == "muladd":
            res = gl.f3_mul(src[0], src[1], src[2])
        elif ci.op == "copy":
            res = src[0]
        else:
            raise ValueError(f"Invalid op {ci.op}")
        assert ci.dest.type_ == "tmp"
        tmp[ci.dest.id] = res
    return get_ref(code[-1].dest)


class StarkVerifierCircuitBN:
    def __init__(self, b, gl, pos, starkinfo, program, ss, const_root_w):
        self.b = b
        self.gl = gl
        self.pos = pos
        self.si = starkinfo
        self.program = program
        self.ss = ss
        self.const_root = const_root_w  # single Fr wire

    # -- 16-ary Merkle verification (merklehash_bn128.rs semantics, with the
    # computed node checked against its slot at every level) --
    def _merkle_verify(self, root_w, leaf_vals: list[GlF], sib_levels,
                       idx_bits):
        b, gl = self.b, self.gl
        cur = self._leaf_hash(leaf_vals)
        for lvl, level in enumerate(sib_levels):
            bits4 = idx_bits[4 * lvl : 4 * lvl + 4]
            while len(bits4) < 4:
                bits4 = bits4 + [b.W()]
            sel = list(level)
            for bit in bits4:
                sel = [b.mux(bit, sel[2 * j], sel[2 * j + 1])
                       for j in range(len(sel) // 2)]
            b.assert_eq(sel[0], cur)
            cur = self.pos.hash_fr(list(level), b.W())
        b.assert_eq(cur, root_w)

    def _leaf_hash(self, vals: list[GlF]):
        """hash_element_matrix: pack 3 GL per Fr, sponge-fold in 16s
        (hash/linearhash_big.py)."""
        b = self.b
        packed = []
        for i in range(0, len(vals), 3):
            chunk = vals[i : i + 3]
            w = chunk[0].w
            for j in range(1, len(chunk)):
                w = w + chunk[j].w.scale(1 << (64 * j))
            packed.append(w)
        if not packed:
            return b.W()
        if len(packed) == 1:
            return packed[0]
        st = b.W()
        for i in range(0, len(packed), 16):
            grp = packed[i : i + 16]
            st = self.pos.hash_fr(grp, st)
        return st

    def verify(self, p: ProofSignalsBN, publics: list[GlF]):
        b, gl, si, ss = self.b, self.gl, self.si, self.ss
        nbits0 = ss.steps[0].nBits

        t = TranscriptBigCircuit(b, self.pos, gl)
        for pub in publics:
            t.put(pub.w)
        t.put(p.root1)
        challenges = [None] * 8
        challenges[0] = t.get_field()
        challenges[1] = t.get_field()
        t.put(p.root2)
        challenges[2] = t.get_field()
        challenges[3] = t.get_field()
        t.put(p.root3)
        challenges[4] = t.get_field()
        t.put(p.root4)
        challenges[7] = t.get_field()
        for ev in p.evals:
            for e in range(3):
                t.put(ev[e].w)
        challenges[5] = t.get_field()
        challenges[6] = t.get_field()
        special_x = []
        for s in range(len(ss.steps)):
            special_x.append(t.get_field())
            if s < len(ss.steps) - 1:
                t.put(p.s_root[s + 1])
            else:
                for v in p.final_pol:
                    for e in range(3):
                        t.put(v[e].w)
        ys = t.get_permutations(ss.nQueries, nbits0)

        self._verify_evaluations(challenges, p.evals, publics)

        for q in range(ss.nQueries):
            out = self._verify_query(p, q, ys[q], challenges)
            self._s0_merkles(p, q, ys[q])
            if len(ss.steps) > 1:
                nxt_bits = ss.steps[1].nBits
                group = [tuple(p.s_vals[1][q][i * 3 + e] for e in range(3))
                         for i in range(1 << (nbits0 - nxt_bits))]
                key = ys[q][nxt_bits:nbits0]
            else:
                group = p.final_pol
                key = ys[q][:nbits0]
            low = self._tree_selector(group, key)
            gl.f3_assert_eq(low, out)

        for s in range(1, len(ss.steps)):
            prev_bits = ss.steps[s - 1].nBits
            cur_bits = ss.steps[s].nBits
            shift_pow = pow(gl64mod.SHIFT, 1 << (ss.nBitsExt - prev_bits),
                            GL_P)
            shift_inv = pow(shift_pow, GL_P - 2, GL_P)
            w_prev_inv = pow(_root(prev_bits), GL_P - 2, GL_P)
            group_size = 1 << (prev_bits - cur_bits)
            for q in range(ss.nQueries):
                self._merkle_verify(p.s_root[s], p.s_vals[s][q],
                                    p.s_sibs[s][q], ys[q][:cur_bits])
                group = [tuple(p.s_vals[s][q][i * 3 + e] for e in range(3))
                         for i in range(group_size)]
                coeffs = self._group_intt(group)
                sx = gl.mux(ys[q][0], gl.const(1), gl.const(w_prev_inv))
                sx = gl.scale(sx, shift_inv)
                for i in range(1, cur_bits):
                    wi_inv = pow(_root(prev_bits - i), GL_P - 2, GL_P)
                    term = gl.mux(ys[q][i], gl.const(1), gl.const(wi_inv))
                    sx = gl.mul(sx, term)
                x = tuple(gl.mul(special_x[s][e], sx) for e in range(3))
                ev = self._eval_pol(coeffs, x)
                if s < len(ss.steps) - 1:
                    nxt_bits = ss.steps[s + 1].nBits
                    ngroup = [tuple(p.s_vals[s + 1][q][i * 3 + e]
                                    for e in range(3))
                              for i in range(1 << (cur_bits - nxt_bits))]
                    key = ys[q][nxt_bits:cur_bits]
                else:
                    ngroup = p.final_pol
                    key = ys[q][:cur_bits]
                low = self._tree_selector(ngroup, key)
                gl.f3_assert_eq(low, ev)

        last_bits = ss.steps[-1].nBits
        max_deg_bits = last_bits - (ss.nBitsExt - ss.nBits)
        coeffs = self._group_intt(p.final_pol)
        for k in range(1 << max_deg_bits, 1 << last_bits):
            for e in range(3):
                gl.assert_zero(coeffs[k][e])

    def _verify_evaluations(self, challenges, evals, publics):
        gl, si, ss = self.gl, self.si, self.ss
        xi = challenges[7]
        z_mul = [gl.f3_mul(xi, xi)]
        for i in range(1, ss.nBits):
            z_mul.append(gl.f3_mul(z_mul[-1], z_mul[-1]))
        xN = z_mul[-1]
        Z = (gl.sub(xN[0], gl.const(1)), xN[1], xN[2])
        refs = {"challenges": challenges, "evals": evals,
                "publics": publics, "Z": Z, "Zp": Z}
        res = _unroll_code_bn(gl, self.program.verifier_code.first, refs)

        x_acc = gl.f3_const(1)
        q_acc = evals[si.ev_idx.get("cm", 0, si.qs[0])]
        for i in range(1, si.q_deg):
            x_acc = gl.f3_mul(x_acc, xN)
            q_step = gl.f3_mul(x_acc, evals[si.ev_idx.get("cm", 0, si.qs[i])])
            q_acc = gl.f3_add(q_acc, q_step)
        q_z = gl.f3_mul(q_acc, Z)
        gl.f3_assert_eq(res, q_z)

    def _verify_query(self, p, q, ybits, challenges):
        gl, si, ss = self.gl, self.si, self.ss
        nbits0 = ss.steps[0].nBits
        shift = gl64mod.SHIFT
        xacc = gl.mux(ybits[0], gl.const(shift),
                      gl.const(shift * _root(nbits0) % GL_P))
        for i in range(1, nbits0):
            term = gl.mux(ybits[i], gl.const(1), gl.const(_root(nbits0 - i)))
            xacc = gl.mul(xacc, term)
        xi = challenges[7]
        den1 = gl.f3_inv((gl.sub(xacc, xi[0]), gl.scale(xi[1], GL_P - 1),
                          gl.scale(xi[2], GL_P - 1)))
        x_div_x_sub_xi = tuple(gl.mul(xacc, den1[e]) for e in range(3))
        wn = _root(ss.nBits)
        den2 = gl.f3_inv((gl.sub(xacc, gl.scale(xi[0], wn)),
                          gl.scale(xi[1], (GL_P - wn) % GL_P),
                          gl.scale(xi[2], (GL_P - wn) % GL_P)))
        x_div_x_sub_wxi = tuple(gl.mul(xacc, den2[e]) for e in range(3))
        refs = {
            "challenges": challenges, "evals": p.evals, "publics": [],
            "xDivXSubXi": x_div_x_sub_xi, "xDivXSubWXi": x_div_x_sub_wxi,
            "consts": p.s0_vals["C"][q],
        }
        for name, key in (("tree1", "1"), ("tree2", "2"), ("tree3", "3"),
                          ("tree4", "4")):
            refs[name] = p.s0_vals.get(key, [[]] * ss.nQueries)[q]
        return _unroll_code_bn(gl, self.program.verifier_query_code.first,
                               refs)

    def _s0_merkles(self, p, q, ybits):
        ss = self.ss
        nbits0 = ss.steps[0].nBits
        roots = {"1": p.root1, "2": p.root2, "3": p.root3, "4": p.root4,
                 "C": self.const_root}
        for name in ("1", "2", "3", "4", "C"):
            if name not in p.s0_vals:
                continue
            self._merkle_verify(roots[name], p.s0_vals[name][q],
                                p.s0_sibs[name][q], ybits[:nbits0])

    def _tree_selector(self, values, key_bits):
        gl = self.gl
        cur = list(values)
        for bit in key_bits:
            cur = [tuple(gl.mux(bit, cur[2 * j][e], cur[2 * j + 1][e])
                         for e in range(3))
                   for j in range(len(cur) // 2)]
        assert len(cur) == 1
        return cur[0]

    def _group_intt(self, values):
        gl = self.gl
        n = len(values)
        nbits = n.bit_length() - 1
        assert 1 << nbits == n
        if n == 1:
            return list(values)
        w_inv = pow(_root(nbits), GL_P - 2, GL_P)
        n_inv = pow(n, GL_P - 2, GL_P)
        out = []
        for i in range(n):
            acc = None
            for j in range(n):
                c = pow(w_inv, (i * j) % n, GL_P) * n_inv % GL_P
                term = gl.f3_scale(values[j], c)
                acc = term if acc is None else gl.f3_add(acc, term)
            out.append(acc)
        return out

    def _eval_pol(self, pol, x):
        gl = self.gl
        if len(pol) == 1:
            return pol[0]
        acc = pol[-1]
        for i in range(len(pol) - 2, -1, -1):
            acc = gl.f3_mul(acc, x, pol[i])
        return acc


def build_final_main(zkin: dict, starkinfo, program, ss, const_root,
                     pbn_module, options=None, record: bool = True,
                     curve_r: int | None = None) -> CircuitBuilder:
    """The on-chain Main: verifies one big-field-hash STARK proof; its only
    public signal is publicsHash = sha256(proverAddr || publics)
    (stark_verifier_circom_onchain.rs Main :1590-1817)."""
    r = curve_r or bn254.R
    b = CircuitBuilder(record=record, prime=r)
    gl = GlCircuit(b)
    pos = PoseidonFrCircuit(b, pbn_module)

    publics_vals = [int(v) % GL_P for v in zkin["publics"]]
    prover_addr = int(zkin.get("proverAddr", "0") or "0", 0) \
        if isinstance(zkin.get("proverAddr", 0), str) else \
        int(zkin.get("proverAddr", 0))
    prover_addr %= 1 << 160

    # public output: sha256(proverAddr_160 || publics_64 each), big-endian
    msg = prover_addr.to_bytes(20, "big")
    for v in publics_vals:
        msg += int(v).to_bytes(8, "big")
    hash_val = int.from_bytes(hashlib.sha256(msg).digest(), "big") % r
    publics_hash = b.public(hash_val)

    addr_w = b.wire(b.sig(prover_addr))
    publics = [gl.input64(v) for v in publics_vals]
    # canonical publics check: CompConstant64(GL_P - 2) === 0  <=>  pub < GL_P
    pub_bits = []
    for pw in publics:
        bits = b.bits(pw.w, 64, strict=False)
        _assert_lt_const(b, bits, GL_P)
        pub_bits.append(bits)

    p = ProofSignalsBN(b, gl, zkin, starkinfo, ss)
    verkey_input = bool(options and getattr(options, "verkey_input", False))
    if verkey_input:
        root_c = b.wire(b.sig(int(zkin["rootC"])))
    else:
        root_c = b.W(k=int(const_root) % r)
    v = StarkVerifierCircuitBN(b, gl, pos, starkinfo, program, ss, root_c)
    v.verify(p, publics)

    # publicsHash wiring (sha256 over MSB-first bits)
    addr_bits = b.bits(addr_w, 160, strict=False)
    msg_bits = [addr_bits[159 - i] for i in range(160)]
    for bits in pub_bits:
        msg_bits.extend(bits[63 - j] for j in range(64))
    out_bits = sha256_bits(b, msg_bits)
    acc = b.W()
    for i, bit in enumerate(out_bits):
        acc = acc + bit.scale(1 << (255 - i))
    b.assert_eq(acc, publics_hash)
    return b
