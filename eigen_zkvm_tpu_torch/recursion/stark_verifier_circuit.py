"""Native STARK-verifier circuit: the recursion layers' core.

Builds, on the CircuitBuilder, the exact verification computation that the
reference renders as circom text (starky/src/stark_verifier_circom.rs:
templates VerifyEvaluations :469, VerifyQuery :564, MapValues :718,
StarkVerifier :815, Main variants :1505/1665/1827) and then compiles with an
external circom compiler — here it is constructed directly as R1CS + custom
gates with an embedded witness, skipping the circom/WASM round trip.

Three Main variants, matching pil2circom's StarkOption combinations
(starky/src/prove.rs:134-139):
  - skip_main:        main = StarkVerifier, publics = inner publics
  - normalization:    main = Main(publics + rootC input), embedded const root
  - aggregation:      main = Main(a/b sub-proofs), rootC wired to verifiers

Port of eigen_zkvm_tpu/recursion/stark_verifier_circuit.py over the port's
starkinfo (stark/starkinfo.py) and ops/gl.py int helpers.
"""
from __future__ import annotations

import numpy as np

from ..ops import gl
from ..stark.types import parse_pil_number
from .circuit import CircuitBuilder, W
from .gadgets import (CircuitTranscript, eval_pol, group_intt, merkle_verify,
                      tree_selector)


def _root(k: int) -> int:
    return int(gl.root_of_unity(k))


def _f3_const(a: int, b: int = 0, c: int = 0):
    return (W(k=a), W(k=b), W(k=c))


class ProofSignals:
    """All signals of one serialized STARK proof (zkin schema,
    starky/src/serializer.rs), allocated on the builder."""

    def __init__(self, b: CircuitBuilder, zkin: dict, starkinfo, ss,
                 prefix: str = ""):
        sN = starkinfo.map_sectionsN

        def g(name):
            return zkin[prefix + name]

        def sig_list(vals):
            return [b.sig(int(v)) for v in vals]

        self.root1 = sig_list(g("root1"))
        self.root2 = sig_list(g("root2"))
        self.root3 = sig_list(g("root3"))
        self.root4 = sig_list(g("root4"))
        self.evals = [tuple(W({s: 1}) for s in sig_list(e)) for e in g("evals")]
        nq = ss.nQueries
        self.s0_vals = {}
        self.s0_sibs = {}
        widths = {"1": sN.get("cm1_2ns"), "2": sN.get("cm2_2ns"),
                  "3": sN.get("cm3_2ns"), "4": sN.get("cm4_2ns"),
                  "C": starkinfo.n_constants}
        for name in ("1", "2", "3", "4", "C"):
            if widths[name] == 0:
                continue
            self.s0_vals[name] = [sig_list(g(f"s0_vals{name}")[q])
                                  for q in range(nq)]
            self.s0_sibs[name] = [[sig_list(lvl)
                                   for lvl in g(f"s0_siblings{name}")[q]]
                                  for q in range(nq)]
        self.s_root = {}
        self.s_vals = {}
        self.s_sibs = {}
        for s in range(1, len(ss.steps)):
            self.s_root[s] = sig_list(g(f"s{s}_root"))
            self.s_vals[s] = [sig_list(g(f"s{s}_vals")[q]) for q in range(nq)]
            self.s_sibs[s] = [[sig_list(lvl) for lvl in g(f"s{s}_siblings")[q]]
                              for q in range(nq)]
        self.final_pol = [tuple(W({s: 1}) for s in sig_list(e))
                          for e in g("finalPol")]


def _unroll_code(b: CircuitBuilder, code, starkinfo, refs):
    """Execute compiled verifier code sections over F3 wire triples —
    the builder analog of stark/vm.py execute_code_one (reference circom
    analog: stark_verifier_circom.rs unrollCode :162)."""
    tmp = {}

    def get_ref(r):
        t = r.type_
        if t == "tmp":
            return tmp[r.id]
        if t in ("tree1", "tree2", "tree3", "tree4"):
            sigs = refs[t]
            if r.dim == 1:
                s = sigs[r.tree_pos]
                return (W({s: 1}), W(), W())
            return tuple(W({sigs[r.tree_pos + e]: 1}) for e in range(3))
        if t == "const":
            return (W({refs["consts"][r.id]: 1}), W(), W())
        if t == "eval":
            return refs["evals"][r.id]
        if t == "number":
            return _f3_const(parse_pil_number(r.value))
        if t == "public":
            v = refs["publics"][r.id]
            return (v, W(), W()) if isinstance(v, W) else v
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
            res = b.f3_add(src[0], src[1])
        elif ci.op == "sub":
            res = b.f3_sub(src[0], src[1])
        elif ci.op == "mul":
            res = b.f3_mul(src[0], src[1])
        elif ci.op == "muladd":
            res = b.f3_mul(src[0], src[1], src[2])
        elif ci.op == "copy":
            res = src[0]
        else:
            raise ValueError(f"Invalid op {ci.op}")
        assert ci.dest.type_ == "tmp"
        tmp[ci.dest.id] = res
    return get_ref(code[-1].dest)


class StarkVerifierCircuit:
    """One StarkVerifier instance (template StarkVerifier,
    stark_verifier_circom.rs:815)."""

    def __init__(self, b: CircuitBuilder, starkinfo, program, ss, const_root):
        self.b = b
        self.si = starkinfo
        self.program = program
        self.ss = ss
        self.const_root = const_root  # list of 4 W wires

    def verify(self, p: ProofSignals, publics):
        b, si, ss = self.b, self.si, self.ss
        nbits0 = ss.steps[0].nBits

        # ---- transcript replay (stark_verifier_circom.rs:989-1021) ----
        t = CircuitTranscript(b)
        for pub in publics:
            t.put(b.materialize(pub[0] if isinstance(pub, tuple) else pub))
        t.put_many(p.root1)
        challenges = [None] * 8
        challenges[0] = t.get_field()
        challenges[1] = t.get_field()
        t.put_many(p.root2)
        challenges[2] = t.get_field()
        challenges[3] = t.get_field()
        t.put_many(p.root3)
        challenges[4] = t.get_field()
        t.put_many(p.root4)
        challenges[7] = t.get_field()
        for ev in p.evals:
            for e in range(3):
                t.put(b.materialize(ev[e]))
        challenges[5] = t.get_field()
        challenges[6] = t.get_field()
        special_x = []
        for s in range(len(ss.steps)):
            special_x.append(t.get_field())
            if s < len(ss.steps) - 1:
                t.put_many(p.s_root[s + 1])
            else:
                for v in p.final_pol:
                    for e in range(3):
                        t.put(b.materialize(v[e]))
        ys = t.get_permutations(ss.nQueries, nbits0)

        # ---- VerifyEvaluations ----
        self._verify_evaluations(challenges, p.evals, publics)

        # ---- queries: step 0 ----
        for q in range(ss.nQueries):
            out = self._verify_query(p, q, ys[q], challenges)
            self._s0_merkles(p, q, ys[q])
            nxt_bits = ss.steps[1].nBits if len(ss.steps) > 1 else 0
            if len(ss.steps) > 1:
                group = [tuple(W({p.s_vals[1][q][i * 3 + e]: 1})
                               for e in range(3))
                         for i in range(1 << (nbits0 - nxt_bits))]
                key = ys[q][nxt_bits:nbits0]
            else:
                group = p.final_pol
                key = ys[q][:nbits0]
            low = tree_selector(b, group, key)
            for e in range(3):
                b.assert_eq(low[e], out[e])

        # ---- FRI steps ----
        shift_pow = 1  # SHIFT^(2^(nBitsExt - prev_bits))
        for s in range(1, len(ss.steps)):
            prev_bits = ss.steps[s - 1].nBits
            cur_bits = ss.steps[s].nBits
            shift_pow = pow(int(gl.SHIFT), 1 << (ss.nBitsExt - prev_bits),
                            int(gl.P_INT))
            shift_inv = pow(shift_pow, int(gl.P_INT) - 2, int(gl.P_INT))
            w_prev_inv = pow(_root(prev_bits), int(gl.P_INT) - 2,
                             int(gl.P_INT))
            group_size = 1 << (prev_bits - cur_bits)
            for q in range(ss.nQueries):
                merkle_verify(
                    b, [W({r: 1}) for r in p.s_root[s]], p.s_vals[s][q],
                    p.s_sibs[s][q], ys[q][:cur_bits])
                group = [tuple(W({p.s_vals[s][q][i * 3 + e]: 1})
                               for e in range(3)) for i in range(group_size)]
                coeffs = group_intt(b, group)
                # sx = (shift_prev * w_prev^(y mod 2^cur))^-1
                sx = ys[q][0].scale(w_prev_inv - 1) + W(k=1)
                sx = sx.scale(shift_inv)
                for i in range(1, cur_bits):
                    wi_inv = pow(_root(prev_bits - i), int(gl.P_INT) - 2,
                                 int(gl.P_INT))
                    sx = b.mul(sx, ys[q][i].scale(wi_inv - 1) + W(k=1))
                x = tuple(b.mul(special_x[s][e], sx) for e in range(3))
                ev = eval_pol(b, coeffs, x)
                if s < len(ss.steps) - 1:
                    nxt_bits = ss.steps[s + 1].nBits
                    ngroup = [tuple(W({p.s_vals[s + 1][q][i * 3 + e]: 1})
                                    for e in range(3))
                              for i in range(1 << (cur_bits - nxt_bits))]
                    key = ys[q][nxt_bits:cur_bits]
                else:
                    ngroup = p.final_pol
                    key = ys[q][:cur_bits]
                low = tree_selector(b, ngroup, key)
                for e in range(3):
                    b.assert_eq(low[e], ev[e])

        # ---- final degree check (lastIFFT) ----
        last_bits = ss.steps[-1].nBits
        max_deg_bits = last_bits - (ss.nBitsExt - ss.nBits)
        coeffs = group_intt(b, p.final_pol)
        for k in range(1 << max_deg_bits, 1 << last_bits):
            for e in range(3):
                b.assert_zero(coeffs[k][e])

    def _verify_evaluations(self, challenges, evals, publics):
        b, si, ss = self.b, self.si, self.ss
        xi = challenges[7]
        z_mul = [b.f3_mul(xi, xi)]
        for i in range(1, ss.nBits):
            z_mul.append(b.f3_mul(z_mul[-1], z_mul[-1]))
        xN = z_mul[-1]
        Z = (xN[0] - W(k=1), xN[1], xN[2])
        # Z at w*xi: ((w*xi)^N - 1) = (xi^N - 1) since w^N == 1
        Zp = Z
        refs = {"challenges": challenges, "evals": evals,
                "publics": publics, "Z": Z, "Zp": Zp}
        res = _unroll_code(b, self.program.verifier_code.first, si, refs)

        x_acc = _f3_const(1)
        q_acc = evals[si.ev_idx.get("cm", 0, si.qs[0])]
        for i in range(1, si.q_deg):
            x_acc = b.f3_mul(x_acc, xN)
            q_step = b.f3_mul(x_acc, evals[si.ev_idx.get("cm", 0, si.qs[i])])
            q_acc = b.f3_add(q_acc, q_step)
        q_z = b.f3_mul(q_acc, Z)
        for e in range(3):
            b.assert_eq(res[e], q_z[e])

    def _verify_query(self, p: ProofSignals, q: int, ybits, challenges):
        """Template VerifyQuery (stark_verifier_circom.rs:561-713)."""
        b, si, ss = self.b, self.si, self.ss
        nbits0 = ss.steps[0].nBits
        shift = int(gl.SHIFT)
        # x = SHIFT * w_ext^idx from the index bits
        xacc = ybits[0].scale(shift * _root(nbits0) - shift) + W(k=shift)
        for i in range(1, nbits0):
            xacc = b.mul(xacc, ybits[i].scale(_root(nbits0 - i) - 1) + W(k=1))
        xi = challenges[7]
        den1 = b.f3_inv((xacc - xi[0], xi[1].scale(int(gl.P_INT) - 1),
                         xi[2].scale(int(gl.P_INT) - 1)))
        x_div_x_sub_xi = tuple(b.mul(xacc, den1[e]) for e in range(3))
        wn = _root(ss.nBits)
        den2 = b.f3_inv((xacc - xi[0].scale(wn),
                         xi[1].scale(int(gl.P_INT) - wn),
                         xi[2].scale(int(gl.P_INT) - wn)))
        x_div_x_sub_wxi = tuple(b.mul(xacc, den2[e]) for e in range(3))

        refs = {
            "challenges": challenges, "evals": p.evals,
            "publics": [], "xDivXSubXi": x_div_x_sub_xi,
            "xDivXSubWXi": x_div_x_sub_wxi,
            "consts": p.s0_vals["C"][q],
        }
        for name, key in (("tree1", "1"), ("tree2", "2"), ("tree3", "3"),
                          ("tree4", "4")):
            refs[name] = p.s0_vals.get(key, [[]] * ss.nQueries)[q]
        return _unroll_code(b, self.program.verifier_query_code.first, si,
                            refs)

    def _s0_merkles(self, p: ProofSignals, q: int, ybits):
        b, si, ss = self.b, self.si, self.ss
        nbits0 = ss.steps[0].nBits
        roots = {"1": p.root1, "2": p.root2, "3": p.root3, "4": p.root4}
        for name in ("1", "2", "3", "4", "C"):
            if name not in p.s0_vals:
                continue
            root = self.const_root if name == "C" else \
                [W({r: 1}) for r in roots[name]]
            merkle_verify(b, root, p.s0_vals[name][q], p.s0_sibs[name][q],
                          ybits[:nbits0])


def build_main(zkin: dict, starkinfo, program, ss, const_root,
               n_publics: int, options, record: bool = True) -> CircuitBuilder:
    """Construct the full Main circuit + witness for one proof input.

    options: object with verkey_input / agg_stage / skip_main booleans
    (pil2circom.rs StarkOption).  n_publics = number of publics of the
    *verified* PIL.  Returns the populated CircuitBuilder.
    """
    b = CircuitBuilder(record=record)
    root_consts = [int(x) for x in np.asarray(const_root, dtype=np.uint64)]

    if options.agg_stage:
        pubs = [b.public(int(v)) for v in zkin["publics"]]
        root_c = [b.public(int(v)) for v in zkin["rootC"]]
        chain = getattr(options, "chain_map", None)
        sub = {}
        for prefix in ("a_", "b_"):
            # per-proof inputs (bound below when a chain_map is given)
            sub_pubs = [b.wire(b.sig(int(v)))
                        for v in zkin[f"{prefix}publics"]]
            sub_root_c = [b.wire(b.sig(int(v)))
                          for v in zkin[f"{prefix}rootC"]]
            p = ProofSignals(b, zkin, starkinfo, ss, prefix=prefix)
            v = StarkVerifierCircuit(b, starkinfo, program, ss, sub_root_c)
            v.verify(p, sub_pubs)
            sub[prefix] = (sub_pubs, sub_root_c)
        if chain is not None:
            # continuation-chain binding (reference zkvm/src/lib.rs:319 —
            # bootloader state injected into the witness): chunk a's
            # outgoing state IS chunk b's incoming state, and the exposed
            # publics are the super-chunk's (in from a, out from b) — a
            # forged boundary register now fails THIS proof, not a host
            # check.  The exposed rootC is pinned to the leaf proof's (b is
            # always a leaf in the left-fold); a's root stays a witness
            # input because a alternates between leaf and aggregate circuit
            # roots — the fold driver (which produced a) pins its value,
            # and the final proof is verified against the aggregation
            # circuit's own const root.
            a_pubs, a_root = sub["a_"]
            b_pubs, b_root = sub["b_"]
            for oa, ib in chain.pairs:
                b.assert_eq(a_pubs[oa], b_pubs[ib])
            assert len(chain.expose) == len(pubs), \
                "chain_map.expose must cover the exposed publics"
            for w, (side, idx) in zip(pubs, chain.expose):
                b.assert_eq(w, (a_pubs if side == "a" else b_pubs)[idx])
            for w, wb in zip(root_c, b_root):
                b.assert_eq(w, wb)
        return b

    if options.skip_main:
        pubs = [b.public(int(v)) for v in zkin["publics"]]
        p = ProofSignals(b, zkin, starkinfo, ss)
        v = StarkVerifierCircuit(b, starkinfo, program, ss,
                                 [W(k=c) for c in root_consts])
        v.verify(p, pubs)
        return b

    # normalization Main: publics + rootC as public inputs; the verifier
    # uses the embedded constant root (stark_verifier_circom.rs:1502-1660).
    pubs = [b.public(int(v)) for v in zkin["publics"]]
    root_c_in = zkin.get("rootC", root_consts)
    root_c_pub = [b.public(int(v)) for v in root_c_in]
    p = ProofSignals(b, zkin, starkinfo, ss)
    root_w = root_c_pub if options.verkey_input else \
        [W(k=c) for c in root_consts]
    v = StarkVerifierCircuit(b, starkinfo, program, ss, root_w)
    v.verify(p, pubs)
    return b
