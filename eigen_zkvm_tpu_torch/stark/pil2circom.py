"""Render the STARK verifier as circom text.

Output-faithful port of the reference transpiler (starky/src/pil2circom.rs +
stark_verifier_circom.rs) so the emitted .circom compiles against
pil-stark's circuits.gl library and circom 2.x, exactly like the
reference's recursion flow.  The native recursion path does NOT use this
(recursion/stark_verifier_circuit.py builds circuits directly); this is the
interop surface for users running the external circom toolchain.

Only the GL (recursion-layer) variant is rendered here; the BN128/BLS12381
on-chain variant is pil2circom_onchain.py.

Port of eigen_zkvm_tpu/stark/pil2circom.py, text for text: host work on
Python ints (the roots, the coset shift and its inverse from ops/gl.py and
ops/f3.py's `*_int` helpers).  `const_root` is the const tree's root as
the port's StarkSetup holds it: four GL values (uint64, or int64 bit
patterns).
"""
from __future__ import annotations

from ..ops import f3
from ..ops import gl


class StarkOption:
    def __init__(self, enable_input=False, verkey_input=False,
                 skip_main=False, agg_stage=False):
        self.enable_input = enable_input
        self.verkey_input = verkey_input
        self.skip_main = skip_main
        self.agg_stage = agg_stage


def _root(k):
    return gl.root_of_unity(k)


def _header(options):
    h = """pragma circom 2.1.0;
pragma custom_templates;

include "cmuladd.circom";
include "cinv.circom";
include "poseidon.circom";
include "bitify.circom";
include "fft.circom";
include "merklehash.circom";
include "evalpol.circom";
include "treeselector.circom";
"""
    if options.agg_stage:
        h += '\ninclude "mux1.circom";\ninclude "iszero.circom";\n'
    return h


class _Transcript:
    """Mirrors stark_verifier_circom.rs Transcript (:39-160)."""

    def __init__(self):
        self.state = ["0"] * 4
        self.pending = []
        self.out = []
        self.h_cnt = 0
        self.n2b_cnt = 0
        self.code = []

    def _flush(self):
        while len(self.pending) < 8:
            self.pending.append("0")
        self.code.append(
            f"signal tcHahs_{self.h_cnt}[12] <== Poseidon(12)"
            f"([{','.join(self.pending)}], [{','.join(self.state)}]);")
        self.h_cnt += 1
        self.out = [f"tcHahs_{self.h_cnt - 1}[{i}]" for i in range(12)]
        self.state = self.out[:4]
        self.pending = []

    def get_fields1(self):
        if not self.out:
            self._flush()
        return self.out.pop(0)

    def get_field(self, v):
        for i in range(3):
            self.code.append(f"{v}[{i}] <== {self.get_fields1()};")

    def put(self, a, length=-1):
        items = [f"{a}[{i}]" for i in range(length)] if length >= 0 else [a]
        for it in items:
            self.out = []
            self.pending.append(it)
            if len(self.pending) == 8:
                self._flush()

    def get_permutations(self, v, n, n_bits):
        n_fields = (n * n_bits - 1) // 63 + 1
        names = []
        for _ in range(n_fields):
            f = self.get_fields1()
            name = f"tcN2b_{self.n2b_cnt}"
            self.n2b_cnt += 1
            self.code.append(f"component {name} = Num2Bits_strict();")
            self.code.append(f"{name}.in <== {f};")
            names.append(name)
        cur_field = cur_bit = 0
        for i in range(n):
            for j in range(n_bits):
                self.code.append(
                    f"{v}[{i}][{j}] <== {names[cur_field]}.out[{cur_bit}];")
                cur_bit += 1
                if cur_bit == 63:
                    cur_bit = 0
                    cur_field += 1

    def get_code(self):
        return "\n".join("    " + c for c in self.code)


def _unroll(code, starkinfo):
    """Mirrors unrollCode (:162-459): 3-address sections -> circom signals."""

    def ref(r):
        t = r.type_
        if t == "eval":
            return f"evals[{r.id}]"
        if t == "challenge":
            return f"challenges[{r.id}]"
        if t == "public":
            return f"publics[{r.id}]"
        if t == "x":
            return "challenges[7]"
        if t == "Z":
            return "Z"
        if t == "xDivXSubXi":
            return "xDivXSubXi"
        if t == "xDivXSubWXi":
            return "xDivXSubWXi"
        if t == "tmp":
            return f"tmp_{r.id}"
        if t == "tree1":
            return f"mapValues.tree1_{r.id}"
        if t == "tree2":
            return f"mapValues.tree2_{r.id - starkinfo.n_cm1}"
        if t == "tree3":
            return f"mapValues.tree3_{r.id - starkinfo.n_cm1 - starkinfo.n_cm2}"
        if t == "tree4":
            return (f"mapValues.tree4_"
                    f"{r.id - starkinfo.n_cm1 - starkinfo.n_cm2 - starkinfo.n_cm3}")
        if t == "const":
            return f"consts[{r.id}]"
        if t == "number":
            return str(r.value)
        raise ValueError(t)

    lines = []
    for inst in code:
        d = ref(inst.dest)
        s = [ref(x) for x in inst.src]
        dims = [x.dim for x in inst.src]
        op = inst.op
        if op == "add":
            if dims[0] == 1 and dims[1] == 1:
                lines.append(f"signal {d} <== {s[0]} + {s[1]};")
            elif dims[0] == 1:
                lines.append(f"signal {d}[3] <== [{s[0]} + {s[1]}[0], "
                             f"{s[1]}[1], {s[1]}[2]];")
            elif dims[1] == 1:
                lines.append(f"signal {d}[3] <== [{s[0]}[0] + {s[1]}, "
                             f"{s[0]}[1], {s[0]}[2]];")
            else:
                lines.append(f"signal {d}[3] <== [{s[0]}[0] + {s[1]}[0], "
                             f"{s[0]}[1] + {s[1]}[1], {s[0]}[2] + {s[1]}[2]];")
        elif op == "sub":
            if dims[0] == 1 and dims[1] == 1:
                lines.append(f"signal {d} <== {s[0]} - {s[1]};")
            elif dims[0] == 1:
                lines.append(f"signal {d}[3] <== [{s[0]} - {s[1]}[0], "
                             f"-{s[1]}[1], -{s[1]}[2]];")
            elif dims[1] == 1:
                lines.append(f"signal {d}[3] <== [{s[0]}[0] - {s[1]}, "
                             f"{s[0]}[1], {s[0]}[2]];")
            else:
                lines.append(f"signal {d}[3] <== [{s[0]}[0] - {s[1]}[0], "
                             f"{s[0]}[1] - {s[1]}[1], {s[0]}[2] - {s[1]}[2]];")
        elif op == "mul":
            if dims[0] == 1 and dims[1] == 1:
                lines.append(f"signal {d} <== {s[0]} * {s[1]};")
            elif dims[0] == 1:
                lines.append(f"signal {d}[3] <== [{s[0]} * {s[1]}[0], "
                             f"{s[0]} * {s[1]}[1], {s[0]} * {s[1]}[2]];")
            elif dims[1] == 1:
                lines.append(f"signal {d}[3] <== [{s[0]}[0] * {s[1]}, "
                             f"{s[0]}[1] * {s[1]}, {s[0]}[2] * {s[1]}];")
            else:
                lines.append(f"signal {d}[3] <== CMul()({s[0]}, {s[1]});")
        elif op == "copy":
            dim = "[3]" if dims[0] == 3 else ""
            lines.append(f"signal {d}{dim} <== {s[0]};")
        elif op == "muladd":
            if inst.src[2].dim == 1 and dims[0] == 1 and dims[1] == 1:
                lines.append(f"signal {d} <== {s[0]} * {s[1]} + {s[2]};")
            else:
                def as3(i):
                    return s[i] if inst.src[i].dim == 3 else f"[{s[i]}, 0, 0]"
                lines.append(f"signal {d}[3] <== CMulAdd()({as3(0)}, {as3(1)},"
                             f" {as3(2)});")
        else:
            raise ValueError(op)
    return "\n    ".join([""] + lines), ref(code[-1].dest)


def _verify_evaluations(starkinfo, program, pil, ss):
    n_evals = len(starkinfo.ev_map)
    n_pub = len(pil.publics)
    ev0 = starkinfo.ev_idx.get("cm", 0, starkinfo.qs[0])
    body, evalP = _unroll(program.verifier_code.first, starkinfo)
    return f"""
template VerifyEvaluations() {{
    signal input challenges[8][3];
    signal input evals[{n_evals}][3];
    signal input publics[{n_pub}];
    signal input enable;

    signal zMul[{ss.nBits}][3];
    for (var i=0; i< {ss.nBits}; i++) {{
        if (i==0) {{
            zMul[i] <== CMul()(challenges[7], challenges[7]);
        }} else {{
            zMul[i] <== CMul()(zMul[i-1], zMul[i-1]);
        }}
    }}

    signal Z[3];
    Z[0] <== zMul[{ss.nBits - 1}][0] -1;
    Z[1] <== zMul[{ss.nBits - 1}][1];
    Z[2] <== zMul[{ss.nBits - 1}][2];{body}
    signal xN[3] <== zMul[{ss.nBits - 1}];

    signal xAcc[{starkinfo.q_deg}][3];
    signal qStep[{starkinfo.q_deg - 1}][3];
    signal qAcc[{starkinfo.q_deg}][3];
    for (var i=0; i< {starkinfo.q_deg}; i++) {{
        if (i==0) {{
            xAcc[0] <== [1, 0, 0];
            qAcc[0] <== evals[{ev0}+i];
        }} else {{
            xAcc[i] <== CMul()(xAcc[i-1], xN);
            qStep[i-1] <== CMul()(xAcc[i], evals[{ev0}+i]);
            qAcc[i][0] <== qAcc[i-1][0] + qStep[i-1][0];
            qAcc[i][1] <== qAcc[i-1][1] + qStep[i-1][1];
            qAcc[i][2] <== qAcc[i-1][2] + qStep[i-1][2];
        }}
    }}
    signal qZ[3] <== CMul()(qAcc[{starkinfo.q_deg - 1}], Z);

// Final Verification
    enable * ({evalP}[0] - qZ[0]) === 0;
    enable * ({evalP}[1] - qZ[1]) === 0;
    enable * ({evalP}[2] - qZ[2]) === 0;
}}
"""


def _verify_query(starkinfo, program, ss):
    sN = starkinfo.map_sectionsN
    nbits0 = ss.steps[0].nBits
    shift = int(gl.SHIFT)
    lines = [f"""
template parallel VerifyQuery() {{
    signal input ys[{nbits0}];
    signal input challenges[8][3];
    signal input evals[{len(starkinfo.ev_map)}][3];
    signal input tree1[{sN.get('cm1_2ns')}];"""]
    for t in (2, 3):
        if sN.get(f"cm{t}_2ns") > 0:
            lines.append(f"    signal input tree{t}[{sN.get(f'cm{t}_2ns')}];")
    lines.append(f"""    signal input tree4[{sN.get('cm4_2ns')}];
    signal input consts[{starkinfo.n_constants}];
    signal output out[3];

    component mapValues = MapValues();

    for (var i=0; i< {sN.get('cm1_2ns')}; i++ ) {{
        mapValues.vals1[i] <== tree1[i];
    }}""")
    for t in (2, 3):
        if sN.get(f"cm{t}_2ns") > 0:
            lines.append(f"""    for (var i=0; i< {sN.get(f'cm{t}_2ns')}; i++ ) {{
        mapValues.vals{t}[i] <== tree{t}[i];
    }}""")
    lines.append(f"""    for (var i=0; i< {sN.get('cm4_2ns')}; i++ ) {{
        mapValues.vals4[i] <== tree4[i];
    }}
    signal xacc[{nbits0}];
    xacc[0] <== ys[0]*({shift} * roots({nbits0})-{shift}) + {shift};
    for (var i=1; i<{nbits0}; i++ ) {{
        xacc[i] <== xacc[i-1] * ( ys[i]*(roots({nbits0} - i) - 1) +1);
    }}
    component den1inv = CInv();
    den1inv.in[0] <== xacc[{nbits0 - 1}] - challenges[7][0];
    den1inv.in[1] <== -challenges[7][1];
    den1inv.in[2] <== -challenges[7][2];
    signal xDivXSubXi[3];
    xDivXSubXi[0] <== xacc[{nbits0 - 1}] * den1inv.out[0];
    xDivXSubXi[1] <== xacc[{nbits0 - 1}] * den1inv.out[1];
    xDivXSubXi[2] <== xacc[{nbits0 - 1}] * den1inv.out[2];

    component den2inv = CInv();
    den2inv.in[0] <== xacc[{nbits0 - 1}] - roots({ss.nBits})*challenges[7][0];
    den2inv.in[1] <== -roots({ss.nBits})*challenges[7][1];
    den2inv.in[2] <== -roots({ss.nBits})*challenges[7][2];
    signal xDivXSubWXi[3];
    xDivXSubWXi[0] <== xacc[{nbits0 - 1}] * den2inv.out[0];
    xDivXSubWXi[1] <== xacc[{nbits0 - 1}] * den2inv.out[1];
    xDivXSubWXi[2] <== xacc[{nbits0 - 1}] * den2inv.out[2];""")
    body, evalQ = _unroll(program.verifier_query_code.first, starkinfo)
    lines.append(body)
    lines.append(f"""    out[0] <== {evalQ}[0];
    out[1] <== {evalQ}[1];
    out[2] <== {evalQ}[2];
}}
""")
    return "\n".join(lines)


def _map_values(starkinfo):
    sN = starkinfo.map_sectionsN
    lines = [f"""
template MapValues() {{
    signal input vals1[{sN.get('cm1_2ns')}];"""]
    for t in (2, 3):
        if sN.get(f"cm{t}_2ns") > 0:
            lines.append(f"    signal input vals{t}[{sN.get(f'cm{t}_2ns')}];")
    lines.append(f"    signal input vals4[{sN.get('cm4_2ns')}];")
    s_names = ["cm1_2ns", "cm2_2ns", "cm3_2ns", "cm4_2ns"]
    for t, sname in enumerate(s_names, start=1):
        for i, ms in enumerate(starkinfo.map_sections.get(sname)):
            p = starkinfo.var_pol_map[ms]
            dim = "[3]" if p.dim == 3 else ""
            lines.append(f"    signal output tree{t}_{i}{dim};")
    for t, sname in enumerate(s_names, start=1):
        for i, ms in enumerate(starkinfo.map_sections.get(sname)):
            p = starkinfo.var_pol_map[ms]
            if p.dim == 1:
                lines.append(f"    tree{t}_{i} <== vals{t}[{p.section_pos}];")
            else:
                for e in range(3):
                    lines.append(f"    tree{t}_{i}[{e}] <== "
                                 f"vals{t}[{p.section_pos + e}];")
    lines.append("}")
    return "\n".join(lines)


def _proof_inputs(starkinfo, ss, prefix=""):
    """The proof signal declarations shared by StarkVerifier and Main."""
    sN = starkinfo.map_sectionsN
    nq = ss.nQueries
    nbits0 = ss.steps[0].nBits
    lines = [f"    signal input {prefix}evals[{len(starkinfo.ev_map)}][3];",
             f"    signal input {prefix}s0_vals1[{nq}][{sN.get('cm1_2ns')}];"]
    for t in (2, 3):
        if sN.get(f"cm{t}_2ns") > 0:
            lines.append(f"    signal input {prefix}s0_vals{t}[{nq}]"
                         f"[{sN.get(f'cm{t}_2ns')}];")
    lines.append(f"    signal input {prefix}s0_vals4[{nq}][{sN.get('cm4_2ns')}];")
    lines.append(f"    signal input {prefix}s0_valsC[{nq}]"
                 f"[{starkinfo.n_constants}];")
    lines.append(f"    signal input {prefix}s0_siblings1[{nq}][{nbits0}][4];")
    for t in (2, 3):
        if sN.get(f"cm{t}_2ns") > 0:
            lines.append(f"    signal input {prefix}s0_siblings{t}[{nq}]"
                         f"[{nbits0}][4];")
    lines.append(f"    signal input {prefix}s0_siblings4[{nq}][{nbits0}][4];")
    lines.append(f"    signal input {prefix}s0_siblingsC[{nq}][{nbits0}][4];")
    for s in range(len(ss.steps) - 1):
        lines.append(f"    signal input {prefix}s{s + 1}_root[4];")
    for s in range(1, len(ss.steps)):
        gsz = (1 << (ss.steps[s - 1].nBits - ss.steps[s].nBits)) * 3
        lines.append(f"    signal input {prefix}s{s}_vals[{nq}][{gsz}];")
        lines.append(f"    signal input {prefix}s{s}_siblings[{nq}]"
                     f"[{ss.steps[s].nBits}][4];")
    lines.append(f"    signal input {prefix}finalPol"
                 f"[{1 << ss.steps[-1].nBits}][3];")
    return lines


def _stark_verifier(starkinfo, pil, ss, const_root, options):
    sN = starkinfo.map_sectionsN
    nq = ss.nQueries
    nbits0 = ss.steps[0].nBits
    lines = [f"""
template StarkVerifier() {{
    signal input publics[{len(pil.publics)}];
    signal input root1[4];
    signal input root2[4];
    signal input root3[4];
    signal input root4[4];"""]
    if options.verkey_input:
        lines.append("    signal input rootC[4];")
    else:
        roots = [int(x) & 0xFFFFFFFFFFFFFFFF for x in const_root]
        lines.append("    signal rootC[4];")
        for i in range(4):
            lines.append(f"    rootC[{i}] <== {roots[i]};")
    lines += _proof_inputs(starkinfo, ss)
    if options.enable_input:
        lines.append("    signal input enable;\n"
                     "    enable * (enable -1 ) === 0;")
    else:
        lines.append("    signal enable;\n    enable <== 1;")
    lines.append("    signal challenges[8][3];")
    for s in range(len(ss.steps)):
        lines.append(f"    signal s{s}_specialX[3];")
    lines.append(f"    signal ys[{nq}][{nbits0}];")

    t = _Transcript()
    t.put("publics", len(pil.publics))
    t.put("root1", 4)
    t.get_field("challenges[0]")
    t.get_field("challenges[1]")
    t.put("root2", 4)
    t.get_field("challenges[2]")
    t.get_field("challenges[3]")
    t.put("root3", 4)
    t.get_field("challenges[4]")
    t.put("root4", 4)
    t.get_field("challenges[7]")
    for i in range(len(starkinfo.ev_map)):
        t.put(f"evals[{i}]", 3)
    t.get_field("challenges[5]")
    t.get_field("challenges[6]")
    for s in range(len(ss.steps)):
        t.get_field(f"s{s}_specialX")
        if s < len(ss.steps) - 1:
            t.put(f"s{s + 1}_root", 4)
        else:
            for j in range(1 << ss.steps[-1].nBits):
                t.put(f"finalPol[{j}]", 3)
    t.get_permutations("ys", nq, nbits0)
    lines.append(t.get_code())

    # VerifyEvaluations + per-query verification
    lines.append(f"""
    component verifyEvaluations = VerifyEvaluations();
    verifyEvaluations.enable <== enable;
    verifyEvaluations.challenges <== challenges;
    verifyEvaluations.publics <== publics;
    verifyEvaluations.evals <== evals;

    component verifyQueries[{nq}];
    component s0_merkle1[{nq}];""")
    trees = ["1"] + [str(t2) for t2 in (2, 3)
                     if sN.get(f"cm{t2}_2ns") > 0] + ["4", "C"]
    for name in trees[1:]:
        lines.append(f"    component s0_merkle{name}[{nq}];")
    lines.append(f"    component s0_lowValues[{nq}];")
    sel0 = nbits0 - (ss.steps[1].nBits if len(ss.steps) > 1 else 0)
    widths = {"1": sN.get("cm1_2ns"), "2": sN.get("cm2_2ns"),
              "3": sN.get("cm3_2ns"), "4": sN.get("cm4_2ns"),
              "C": starkinfo.n_constants}
    lines.append(f"    for (var q=0; q<{nq}; q++) {{")
    lines.append("        verifyQueries[q] = VerifyQuery();")
    for name in trees:
        lines.append(f"        s0_merkle{name}[q] = MerkleHash(1, "
                     f"{widths[name]}, {1 << nbits0});")
    lines.append(f"        s0_lowValues[q] = TreeSelector({sel0}, 3) ;")
    lines.append(f"        for (var i=0; i<{nbits0}; i++ ) {{")
    lines.append("            verifyQueries[q].ys[i] <== ys[q][i];")
    for name in trees:
        lines.append(f"            s0_merkle{name}[q].key[i] <== ys[q][i];")
    lines.append("        }")
    for name in trees:
        tname = "consts" if name == "C" else f"tree{name}"
        lines.append(f"""        for (var i=0; i<{widths[name]}; i++ ) {{
            verifyQueries[q].{tname}[i] <== s0_vals{name}[q][i];
            s0_merkle{name}[q].values[i][0] <== s0_vals{name}[q][i];
        }}""")
    lines.append("""        verifyQueries[q].challenges <== challenges;
        verifyQueries[q].evals <== evals;""")
    lines.append(f"        for (var i=0; i<{nbits0};i++) {{\n"
                 "            for (var j=0; j<4; j++) {")
    for name in trees:
        lines.append(f"                s0_merkle{name}[q].siblings[i][j] "
                     f"<== s0_siblings{name}[q][i][j];")
    lines.append("            }\n        }")
    if len(ss.steps) > 1:
        g0 = 1 << (nbits0 - ss.steps[1].nBits)
        lines.append(f"""        for (var i=0; i<{g0}; i++) {{
            for (var e=0; e<3; e++) {{
                s0_lowValues[q].values[i][e] <== s1_vals[q][i*3+e];
            }}
        }}
        for (var i=0; i<{nbits0 - ss.steps[1].nBits}; i++) {{
            s0_lowValues[q].key[i] <== ys[q][i + {ss.steps[1].nBits}];
        }}""")
    else:
        lines.append(f"""        for (var i=0; i<{1 << nbits0}; i++) {{
            for (var e=0; e<3; e++) {{
                s0_lowValues[q].values[i][e] <== finalPol[i][e];
            }}
        }}
        for (var i=0; i<{nbits0}; i++) {{
            s0_lowValues[q].key[i] <== ys[q][i];
        }}""")
    lines.append("    }")

    for s in range(1, len(ss.steps)):
        prev, cur = ss.steps[s - 1].nBits, ss.steps[s].nBits
        nxt = ss.steps[s + 1].nBits if s < len(ss.steps) - 1 else 0
        gsz = 1 << (prev - cur)
        shift_inv_pow = f3.inv_int((pow(
            gl.SHIFT, 1 << (ss.nBitsExt - prev), gl.P_INT), 0, 0))[0]
        w_inv_m1 = (pow(_root(prev), gl.P_INT - 2, gl.P_INT) - 1) % gl.P_INT
        lines.append(f"""
    component s{s}_merkle[{nq}];
    component s{s}_fft[{nq}];
    component s{s}_evalPol[{nq}];
    component s{s}_lowValues[{nq}];
    signal s{s}_sx[{nq}][{cur}];
    for (var q=0; q<{nq}; q++) {{
        s{s}_merkle[q] = MerkleHash(3, {gsz}, {1 << cur});
        s{s}_fft[q] = FFT({prev - cur}, 3, 1);
        s{s}_evalPol[q] = EvalPol({gsz});
        s{s}_lowValues[q] = TreeSelector({cur - nxt}, 3) ;
        for (var i=0; i< {gsz}; i++) {{
            for (var e=0; e<3; e++) {{
                s{s}_merkle[q].values[i][e] <== s{s}_vals[q][i*3+e];
                s{s}_fft[q].in[i][e] <== s{s}_vals[q][i*3+e];
            }}
        }}
        for (var i=0; i<{cur}; i++) {{
            for (var j=0; j<4; j++) {{
                s{s}_merkle[q].siblings[i][j] <== s{s}_siblings[q][i][j];
            }}
            s{s}_merkle[q].key[i] <== ys[q][i];
        }}
        s{s}_sx[q][0] <==  {shift_inv_pow} *  ( ys[q][0] * {w_inv_m1} +1);
        for (var i=1; i<{cur}; i++) {{
            s{s}_sx[q][i] <== s{s}_sx[q][i-1] *  ( ys[q][i] * ((1/roots({prev} -i)) -1) +1);
        }}
        for (var i=0; i< {gsz}; i++) {{
            for (var e=0; e<3; e++) {{
                s{s}_evalPol[q].pol[i][e] <== s{s}_fft[q].out[i][e];
            }}
        }}
        for (var e=0; e<3; e++) {{
            s{s}_evalPol[q].x[e] <== s{s}_specialX[e] *  s{s}_sx[q][{cur - 1}];
        }}""")
        if s < len(ss.steps) - 1:
            lines.append(f"""        for (var i=0; i<{1 << (cur - nxt)}; i++) {{
            for (var e=0; e<3; e++) {{
                s{s}_lowValues[q].values[i][e] <== s{s + 1}_vals[q][i*3+e];
            }}
        }}
        for (var i=0; i<{cur - nxt}; i++) {{
            s{s}_lowValues[q].key[i] <== ys[q][i + {nxt}];
        }}""")
        else:
            lines.append(f"""        for (var i=0; i<{1 << cur}; i++) {{
            for (var e=0; e<3; e++) {{
                s{s}_lowValues[q].values[i][e] <== finalPol[i][e];
            }}
        }}
        for (var i=0; i<{cur}; i++) {{
            s{s}_lowValues[q].key[i] <== ys[q][i];
        }}""")
        lines.append(f"""        for (var e=0; e<3; e++) {{
            enable * (s{s}_lowValues[q].out[e] - s{s}_evalPol[q].out[e]) === 0;
        }}
        for (var j=0; j<4; j++) {{
            enable * (s{s}_merkle[q].root[j] - s{s}_root[j]) === 0;
        }}
    }}""")

    root_checks = []
    for name in trees:
        rname = "rootC" if name == "C" else f"root{name}"
        root_checks.append(f"            enable * (s0_merkle{name}[q].root[j]"
                           f" - {rname}[j]) === 0;")
    lines.append(f"""
    for(var q = 0; q < {nq}; q ++) {{
        for(var j = 0; j < 4; j ++) {{
{chr(10).join(root_checks)}
        }}
        for (var e = 0; e < 3; e ++) {{
            enable * (s0_lowValues[q].out[e] - verifyQueries[q].out[e]) === 0;
        }}
    }}""")

    last = ss.steps[-1].nBits
    max_deg = last - (ss.nBitsExt - ss.nBits)
    lines.append(f"""
    component lastIFFT = FFT({last}, 3, 1);
    for (var k=0; k< {1 << last}; k++ ){{
        for (var e=0; e<3; e++) {{
            lastIFFT.in[k][e] <== finalPol[k][e];
        }}
    }}
    for (var k= {1 << max_deg}; k< {1 << last}; k++ ) {{
        for (var e=0; e<3; e++) {{
            enable * lastIFFT.out[k][e] === 0;
        }}
    }}
}}
""")
    return "\n".join(lines)


def _main_template(starkinfo, pil, ss, options):
    nq = ss.nQueries
    sN = starkinfo.map_sectionsN
    trees = ["1"] + [str(t2) for t2 in (2, 3)
                     if sN.get(f"cm{t2}_2ns") > 0] + ["4", "C"]
    if options.agg_stage:
        lines = [f"""
template Main() {{
    signal input publics[{len(pil.publics) - 4}];
    signal input rootC[4];"""]
        for pre in ("a_", "b_"):
            lines.append(f"""    signal input {pre}publics[{len(pil.publics)}];
    signal input {pre}root1[4];
    signal input {pre}root2[4];
    signal input {pre}root3[4];
    signal input {pre}root4[4];
    signal input {pre}rootC[4];""")
            lines += _proof_inputs(starkinfo, ss, prefix=pre)
        for comp, pre in (("vA", "a_"), ("vB", "b_")):
            lines.append(f"""
    component {comp} = StarkVerifier();
    {comp}.publics <== {pre}publics;
    {comp}.root1 <== {pre}root1;
    {comp}.root2 <== {pre}root2;
    {comp}.root3 <== {pre}root3;
    {comp}.root4 <== {pre}root4;
    {comp}.rootC <== {pre}rootC;
    {comp}.evals <== {pre}evals;""")
            for name in trees:
                vn = "C" if name == "C" else name
                lines.append(f"    {comp}.s0_vals{vn} <== {pre}s0_vals{vn};")
                lines.append(f"    {comp}.s0_siblings{vn} <== "
                             f"{pre}s0_siblings{vn};")
            for s in range(1, len(ss.steps)):
                lines.append(f"    {comp}.s{s}_root <== {pre}s{s}_root;")
                lines.append(f"    {comp}.s{s}_vals <== {pre}s{s}_vals;")
                lines.append(f"    {comp}.s{s}_siblings <== {pre}s{s}_siblings;")
            lines.append(f"    {comp}.finalPol <== {pre}finalPol;")
        lines.append("}")
        return "\n".join(lines)

    lines = [f"""
template Main() {{
    signal input publics[{len(pil.publics)}];
    signal input root1[4];
    signal input root2[4];
    signal input root3[4];
    signal input root4[4];
    signal input rootC[4];"""]
    lines += _proof_inputs(starkinfo, ss)
    lines.append("""
    component vA = StarkVerifier();
    vA.publics <== publics;
    vA.root1 <== root1;
    vA.root2 <== root2;
    vA.root3 <== root3;
    vA.root4 <== root4;""")
    if options.verkey_input:
        lines.append("    vA.rootC <== rootC;")
    lines.append("    vA.evals <== evals;")
    for name in trees:
        lines.append(f"    vA.s0_vals{name} <== s0_vals{name};")
        lines.append(f"    vA.s0_siblings{name} <== s0_siblings{name};")
    for s in range(1, len(ss.steps)):
        lines.append(f"    vA.s{s}_root <== s{s}_root;")
        lines.append(f"    vA.s{s}_vals <== s{s}_vals;")
        lines.append(f"    vA.s{s}_siblings <== s{s}_siblings;")
    lines.append("    vA.finalPol <== finalPol;")
    lines.append("}")
    return "\n".join(lines)


def pil2circom(pil, const_root, ss, starkinfo, program, options=None) -> str:
    """Render the verifier (reference entry: pil2circom.rs:21)."""
    options = options or StarkOption()
    if ss.verificationHashType in ("BN128", "BLS12381"):
        from .pil2circom_onchain import render_onchain
        return render_onchain(pil, const_root, ss, starkinfo, program,
                              options)
    if ss.verificationHashType != "GL":
        raise ValueError(f"invalid hash type {ss.verificationHashType}")
    out = _header(options)
    out += _verify_evaluations(starkinfo, program, pil, ss)
    out += _verify_query(starkinfo, program, ss)
    out += _map_values(starkinfo)
    out += _stark_verifier(starkinfo, pil, ss, const_root, options)
    if not options.skip_main:
        out += _main_template(starkinfo, pil, ss, options)
        out += "\n\ncomponent main {public [publics, rootC]}= Main();\n"
    else:
        out += "\n\ncomponent main {public [publics]}= StarkVerifier();\n"
    return out
