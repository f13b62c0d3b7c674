"""Render the on-chain (BN128/BLS12381-hash) STARK verifier as circom text.

Output-faithful port of the reference transpiler for the final layer
(starky/src/stark_verifier_circom_onchain.rs): Goldilocks arithmetic through
the gl.circom gadgets, 16-ary MerkleHash, big-field Poseidon transcript with
BN1toGL3 chunking, and a Main whose only public output is
sha256(proverAddr || publics).  Compiles against the reference's
stark-circuits library (stark-circuits/circuits/*.circom) with circom 2.x.

The native path does not use this (recursion/stark_verifier_circuit_bn.py
builds the same circuit directly); this is the external-toolchain surface.

Port of eigen_zkvm_tpu/stark/pil2circom_onchain.py, text for text, on
Python ints (ops/gl.py's roots and coset shift).  `const_root` is the big
field's root as the port's StarkSetup holds it (one int).
"""
from __future__ import annotations

from ..ops import gl


def _root(k):
    return gl.root_of_unity(k)


def _inv(x):
    return pow(int(x), gl.P_INT - 2, gl.P_INT)


_HEADER = """pragma circom 2.0.6;

include "gl.circom";
include "poseidon.circom";
include "bitify.circom";
include "sha256/sha256.circom";
include "fft.circom";
include "merklehash.circom";
include "evalpol.circom";
include "treeselector.circom";
include "bn1togl3.circom";
include "compconstant64.circom";
"""


class _Transcript:
    """stark_verifier_circom_onchain.rs Transcript (:33-184)."""

    def __init__(self, ss):
        self.ss = ss
        self.state = "0"
        self.pending = []
        self.out = []
        self.out3 = []
        self.h_cnt = 0
        self.n2b_cnt = 0
        self.bn1togl3_cnt = 0
        self.code = []

    def _update(self):
        while len(self.pending) < 16:
            self.pending.append("0")
        h = self.h_cnt
        self.code.append(f"component tcHahs_{h} = PoseidonEx(16,17);")
        self.h_cnt += 1
        for i in range(16):
            self.code.append(f"tcHahs_{h}.inputs[{i}] <== {self.pending[i]};")
        self.out = [f"tcHahs_{h}.out[{i}]" for i in range(17)]
        self.out3 = []
        self.code.append(f"tcHahs_{h}.initialState <== {self.state};")
        self.state = f"tcHahs_{h}.out[0]"
        self.pending = []

    def get_fields1(self):
        if self.out3:
            return self.out3.pop(0)
        if self.out:
            c = f"bn1togl3_{self.bn1togl3_cnt}"
            self.bn1togl3_cnt += 1
            self.code.append(f"component {c} = BN1toGL3();")
            first = self.out.pop(0)
            self.code.append(f"{c}.in <== {first};")
            self.out3 = [f"{c}.out[0]", f"{c}.out[1]", f"{c}.out[2]"]
            return self.get_fields1()
        self._update()
        return self.get_fields1()

    def get_fields253(self):
        if not self.out:
            self._update()
        return self.out.pop(0)

    def get_field(self, v):
        for i in range(3):
            self.code.append(f"{v}[{i}] <== {self.get_fields1()};")

    def put(self, a, length=-1):
        items = [f"{a}[{i}]" for i in range(length)] if length >= 0 else [a]
        for it in items:
            self.out = []
            self.out3 = []
            self.pending.append(it)
            if len(self.pending) == 16:
                self._update()

    def get_permutations(self, v, n, n_bits):
        n_fields = (n * n_bits - 1) // 253 + 1
        n2bt = "Num2Bits_strict()" \
            if self.ss.verificationHashType == "BN128" else "Num2Bits(255)"
        names = []
        for _ in range(n_fields):
            f = self.get_fields253()
            name = f"tcN2b_{self.n2b_cnt}"
            self.n2b_cnt += 1
            self.code.append(f"component {name} = {n2bt};")
            self.code.append(f"{name}.in <== {f};")
            names.append(name)
        cur_field = cur_bit = 0
        for i in range(n):
            for j in range(n_bits):
                self.code.append(
                    f"{v}[{i}][{j}] <== {names[cur_field]}.out[{cur_bit}];")
                cur_bit += 1
                if cur_bit == 253:
                    cur_bit = 0
                    cur_field += 1

    def get_code(self):
        return "\n".join("    " + c for c in self.code)


def _unroll(code, starkinfo):
    """GL ops through gl.circom components (onchain unrollCode :186-413)."""

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
            return "xDivXSubXi.out"
        if t == "xDivXSubWXi":
            return "xDivXSubWXi.out"
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
                lines.append(f"signal {d}[3] <== [{s[0]} - {s[1]}[0] + p, "
                             f"-{s[1]}[1] + p, -{s[1]}[2] + p];")
            elif dims[1] == 1:
                lines.append(f"signal {d}[3] <== [{s[0]}[0] - {s[1]} + p, "
                             f"{s[0]}[1], {s[0]}[2]];")
            else:
                lines.append(
                    f"signal {d}[3] <== [{s[0]}[0] - {s[1]}[0] + p, "
                    f"{s[0]}[1] - {s[1]}[1] + p, {s[0]}[2] - {s[1]}[2] + p];")
        elif op == "mul":
            if dims[0] == 1 and dims[1] == 1:
                lines.append(f"signal {d} <== GLMul()({s[0]}, {s[1]});")
            elif dims[0] == 1:
                lines.append(f"signal {d}[3] <== GLCMul()([{s[0]}, 0, 0], "
                             f"{s[1]});")
            elif dims[1] == 1:
                lines.append(f"signal {d}[3] <== GLCMul()({s[0]}, "
                             f"[{s[1]}, 0, 0]);")
            else:
                lines.append(f"signal {d}[3] <== GLCMul()({s[0]}, {s[1]});")
        elif op == "copy":
            dim = "[3]" if dims[0] == 3 else ""
            lines.append(f"signal {d}{dim} <== {s[0]};")
        elif op == "muladd":
            if dims[0] == 1 and dims[1] == 1 and inst.src[2].dim == 1:
                lines.append(f"signal {d} <== GLMulAdd()({s[0]}, {s[1]}, "
                             f"{s[2]});")
            else:
                def as3(i):
                    return s[i] if inst.src[i].dim == 3 else f"[{s[i]}, 0, 0]"
                lines.append(f"signal {d}[3] <== GLCMulAdd()({as3(0)}, "
                             f"{as3(1)}, {as3(2)});")
        else:
            raise ValueError(op)
    return "\n    ".join([""] + lines), ref(code[-1].dest)


def _verify_evaluations(starkinfo, program, pil, ss):
    body, evalP = _unroll(program.verifier_code.first, starkinfo)
    ev0 = starkinfo.ev_idx.get("cm", 0, starkinfo.qs[0])
    return f"""
template VerifyEvaluations() {{
    signal input challenges[8][3];
    signal input evals[{len(starkinfo.ev_map)}][3];
    signal input publics[{len(pil.publics)}];
    signal input enable;

    var p = 0xFFFFFFFF00000001;

    component zMul[{ss.nBits}];
    for (var i=0; i< {ss.nBits}; i++) {{
        zMul[i] = GLCMul();
        if (i==0) {{
            zMul[i].ina <== challenges[7];
            zMul[i].inb <== challenges[7];
        }} else {{
            zMul[i].ina <== zMul[i-1].out;
            zMul[i].inb <== zMul[i-1].out;
        }}
    }}

    signal Z[3];
    Z[0] <== zMul[{ss.nBits - 1}].out[0] -1 + p;
    Z[1] <== zMul[{ss.nBits - 1}].out[1];
    Z[2] <== zMul[{ss.nBits - 1}].out[2];{body}
    signal xN[3] <== zMul[{ss.nBits - 1}].out;

    signal xAcc[{starkinfo.q_deg}][3];
    signal qStep[{starkinfo.q_deg - 1}][3];
    signal qAcc[{starkinfo.q_deg}][3];
    for (var i=0; i< {starkinfo.q_deg}; i++) {{
        if (i==0) {{
            xAcc[0] <== [1, 0, 0];
            qAcc[0] <== evals[{ev0}+i];
        }} else {{
            xAcc[i] <== GLCMul()(xAcc[i-1], xN);
            qStep[i-1] <== GLCMul()(xAcc[i], evals[{ev0}+i]);
            qAcc[i][0] <== qAcc[i-1][0] + qStep[i-1][0];
            qAcc[i][1] <== qAcc[i-1][1] + qStep[i-1][1];
            qAcc[i][2] <== qAcc[i-1][2] + qStep[i-1][2];
        }}
    }}
    signal qZ[3] <== GLCMul()(qAcc[{starkinfo.q_deg - 1}], Z);

// Final Verification
    component normC = GLCNorm();
    normC.in[0] <== {evalP}[0] - qZ[0] + p;
    normC.in[1] <== {evalP}[1] - qZ[1] + p;
    normC.in[2] <== {evalP}[2] - qZ[2] + p;

    enable * normC.out[0] === 0;
    enable * normC.out[1] === 0;
    enable * normC.out[2] === 0;
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
            lines.append(
                f"""    for (var i=0; i< {sN.get(f'cm{t}_2ns')}; i++ ) {{
        mapValues.vals{t}[i] <== tree{t}[i];
    }}""")
    lines.append(f"""    for (var i=0; i< {sN.get('cm4_2ns')}; i++ ) {{
        mapValues.vals4[i] <== tree4[i];
    }}
    var p = 0xFFFFFFFF00000001;

    component xacc[{nbits0}-1];
    for (var i=1; i<{nbits0}; i++ ) {{
        xacc[i-1] = GLMul();
        if (i==1) {{
            xacc[i-1].ina <== ys[0]*({shift} * roots({nbits0})-{shift}) + {shift};
        }} else {{
            xacc[i-1].ina <== xacc[i-2].out;
        }}
        xacc[i-1].inb <== ys[i]*(roots({nbits0} - i) - 1) +1;
    }}""")
    if nbits0 > 1:
        lines.append(f"    signal X <== xacc[{nbits0 - 2}].out;")
    else:
        lines.append(f"    signal X <== ys[0]*({shift} * roots({nbits0})"
                     f"-{shift}) + {shift};")
    lines.append(f"""
    component den1inv = GLCInv();
    den1inv.in[0] <== X - challenges[7][0] + p;
    den1inv.in[1] <== -challenges[7][1] + p;
    den1inv.in[2] <== -challenges[7][2] + p;

    component xDivXSubXi = GLCMul();
    xDivXSubXi.ina <== [X, 0, 0];
    xDivXSubXi.inb <== den1inv.out;

    component wXi = GLCMul();
    wXi.ina <== [roots({ss.nBits}), 0, 0];
    wXi.inb <== challenges[7];

    component den2inv = GLCInv();
    den2inv.in[0] <== X - wXi.out[0] + p;
    den2inv.in[1] <== -wXi.out[1] + p;
    den2inv.in[2] <== -wXi.out[2] + p;

    component xDivXSubWXi = GLCMul();
    xDivXSubWXi.ina <== [X, 0, 0];
    xDivXSubWXi.inb <== den2inv.out;""")
    body, evalQ = _unroll(program.verifier_query_code.first, starkinfo)
    lines.append(body)
    lines.append(f"""    component normC = GLCNorm();
    normC.in[0] <== {evalQ}[0];
    normC.in[1] <== {evalQ}[1];
    normC.in[2] <== {evalQ}[2];

    out[0] <== normC.out[0];
    out[1] <== normC.out[1];
    out[2] <== normC.out[2];
}}
""")
    return "\n".join(lines)


def _map_values(starkinfo):
    # identical layout to the GL variant
    from .pil2circom import _map_values as mv
    return mv(starkinfo)


def _stark_verifier(starkinfo, pil, ss, const_root_scalar, options):
    sN = starkinfo.map_sectionsN
    nq = ss.nQueries
    nbits0 = ss.steps[0].nBits
    trees = ["1"] + [str(t) for t in (2, 3)
                     if sN.get(f"cm{t}_2ns") > 0] + ["4", "C"]
    widths = {"1": sN.get("cm1_2ns"), "2": sN.get("cm2_2ns"),
              "3": sN.get("cm3_2ns"), "4": sN.get("cm4_2ns"),
              "C": starkinfo.n_constants}
    nsib0 = (nbits0 - 1) // 4 + 1
    lines = [f"""
template StarkVerifier() {{
    signal input publics[{len(pil.publics)}];
    signal input root1;
    signal input root2;
    signal input root3;
    signal input root4;"""]
    if options.verkey_input:
        lines.append("    signal input rootC;")
    else:
        lines.append(f"    signal rootC;\n    rootC <== {const_root_scalar};")
    lines.append(f"""    signal input evals[{len(starkinfo.ev_map)}][3];
    signal input s0_vals1[{nq}][{widths['1']}];""")
    for t in (2, 3):
        if sN.get(f"cm{t}_2ns") > 0:
            lines.append(f"    signal input s0_vals{t}[{nq}][{widths[str(t)]}];")
    lines.append(f"""    signal input s0_vals4[{nq}][{widths['4']}];
    signal input s0_valsC[{nq}][{widths['C']}];
    signal input s0_siblings1[{nq}][{nsib0}][16];""")
    for t in (2, 3):
        if sN.get(f"cm{t}_2ns") > 0:
            lines.append(f"    signal input s0_siblings{t}[{nq}][{nsib0}][16];")
    lines.append(f"""    signal input s0_siblings4[{nq}][{nsib0}][16];
    signal input s0_siblingsC[{nq}][{nsib0}][16];""")
    for s in range(len(ss.steps) - 1):
        lines.append(f"    signal input s{s + 1}_root;")
    for s in range(1, len(ss.steps)):
        gsz = (1 << (ss.steps[s - 1].nBits - ss.steps[s].nBits)) * 3
        nsib = (ss.steps[s].nBits - 1) // 4 + 1
        lines.append(f"    signal input s{s}_vals[{nq}][{gsz}];")
        lines.append(f"    signal input s{s}_siblings[{nq}][{nsib}][16];")
    lines.append(f"    signal input finalPol[{1 << ss.steps[-1].nBits}][3];")
    if options.enable_input:
        lines.append("    signal input enable;\n"
                     "    enable * (enable -1 ) === 0;")
    else:
        lines.append("    signal enable;\n    enable <== 1;")
    lines.append("    signal challenges[8][3];")
    for s in range(len(ss.steps)):
        lines.append(f"    signal s{s}_specialX[3];")
    lines.append(f"""    signal ys[{nq}][{nbits0}];

    var p = 0xFFFFFFFF00000001;""")

    t = _Transcript(ss)
    t.put("publics", len(pil.publics))
    t.put("root1")
    t.get_field("challenges[0]")
    t.get_field("challenges[1]")
    t.put("root2")
    t.get_field("challenges[2]")
    t.get_field("challenges[3]")
    t.put("root3")
    t.get_field("challenges[4]")
    t.put("root4")
    t.get_field("challenges[7]")
    for i in range(len(starkinfo.ev_map)):
        t.put(f"evals[{i}]", 3)
    t.get_field("challenges[5]")
    t.get_field("challenges[6]")
    for s in range(len(ss.steps)):
        t.get_field(f"s{s}_specialX")
        if s < len(ss.steps) - 1:
            t.put(f"s{s + 1}_root")
        else:
            for j in range(1 << ss.steps[-1].nBits):
                t.put(f"finalPol[{j}]", 3)
    t.get_permutations("ys", nq, nbits0)
    lines.append(t.get_code())

    lines.append(f"""
    component verifyEvaluations = VerifyEvaluations();
    verifyEvaluations.enable <== enable;
    verifyEvaluations.challenges <== challenges;
    verifyEvaluations.publics <== publics;
    verifyEvaluations.evals <== evals;

    component verifyQueries[{nq}];""")
    for name in trees:
        lines.append(f"    component s0_merkle{name}[{nq}];")
    lines.append(f"    component s0_lowValues[{nq}];")
    sel0 = nbits0 - (ss.steps[1].nBits if len(ss.steps) > 1 else 0)
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
    lines.append(f"        for (var i=0; i<{nsib0};i++) {{\n"
                 "            for (var j=0; j<16; j++) {")
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
        nsib = (cur - 1) // 4 + 1
        e0 = _inv(pow(int(gl.SHIFT), 1 << (ss.nBitsExt - prev), gl.P_INT))
        e1 = e0 * _inv(_root(prev)) % gl.P_INT
        lines.append(f"""
    component s{s}_merkle[{nq}];
    component s{s}_fft[{nq}];
    component s{s}_evalPol[{nq}];
    component s{s}_lowValues[{nq}];
    component s{s}_cNorm[{nq}];
    component s{s}_sx[{nq}][{cur - 1}];
    component s{s}_evalXprime[{nq}];
    signal s{s}_X[{nq}];
    for (var q=0; q<{nq}; q++) {{
        s{s}_merkle[q] = MerkleHash(3, {gsz}, {1 << cur});
        s{s}_fft[q] = FFT({prev - cur}, 1);
        s{s}_evalPol[q] = EvalPol({gsz});
        s{s}_lowValues[q] = TreeSelector({cur - nxt}, 3) ;
        for (var i=0; i< {gsz}; i++) {{
            for (var e=0; e<3; e++) {{
                s{s}_merkle[q].values[i][e] <== s{s}_vals[q][i*3+e];
                s{s}_fft[q].in[i][e] <== s{s}_vals[q][i*3+e];
            }}
        }}
        for (var i=0; i<{nsib}; i++) {{
            for (var j=0; j<16; j++) {{
                s{s}_merkle[q].siblings[i][j] <== s{s}_siblings[q][i][j];
            }}
        }}
        for (var i=0; i<{cur}; i++) {{
            s{s}_merkle[q].key[i] <== ys[q][i];
        }}
        for (var i=1; i<{cur}; i++ ) {{
            s{s}_sx[q][i-1] = GLMul();
            if (i==1) {{
                s{s}_sx[q][i-1].ina <== ys[q][0] * ({e1} - {e0}) + {e0};
            }} else {{
                s{s}_sx[q][i-1].ina <== s{s}_sx[q][i-2].out;
            }}
            s{s}_sx[q][i-1].inb <== ys[q][i] * (_inv1(roots({prev} -i)) -1) +1;
        }}""")
        if nbits0 > 1:
            lines.append(f"        s{s}_X[q] <== s{s}_sx[q][{cur - 2}].out;")
        else:
            w_m1 = (_root(prev) - 1) % gl.P_INT
            lines.append(f"        s{s}_X[q] <== {e0} *  "
                         f"( ys[q][0] * {w_m1} +1);")
        lines.append(f"""        for (var i=0; i< {gsz}; i++) {{
            for (var e=0; e<3; e++) {{
                s{s}_evalPol[q].pol[i][e] <== s{s}_fft[q].out[i][e];
            }}
        }}
        s{s}_evalXprime[q] = GLCMul();
        s{s}_evalXprime[q].ina <== s{s}_specialX;
        s{s}_evalXprime[q].inb <== [s{s}_X[q], 0, 0];
        for (var e=0; e<3; e++) {{
            s{s}_evalPol[q].x[e] <== s{s}_evalXprime[q].out[e];
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
        lines.append(f"""        s{s}_cNorm[q] = GLCNorm();
        for (var e=0; e<3; e++) {{
            s{s}_cNorm[q].in[e] <== s{s}_evalPol[q].out[e] - s{s}_lowValues[q].out[e] + p;
        }}
    }}""")

    root_checks = []
    for name in trees:
        rname = "rootC" if name == "C" else f"root{name}"
        root_checks.append(f"        enable * (s0_merkle{name}[q].root - "
                           f"{rname}) === 0;")
    lines.append(f"""
    for (var q=0; q < {nq}; q ++) {{
{chr(10).join(root_checks)}
        for (var e=0; e<3; e++) {{
            enable * (s0_lowValues[q].out[e] - verifyQueries[q].out[e]) === 0;
        }}
    }}""")
    for s in range(1, len(ss.steps)):
        lines.append(f"""    for (var q = 0; q < {nq}; q ++) {{
        for (var e=0; e<3; e++) {{
            enable * s{s}_cNorm[q].out[e] === 0;
        }}
        enable * (s{s}_merkle[q].root - s{s}_root) === 0;
    }}""")

    last = ss.steps[-1].nBits
    max_deg = last - (ss.nBitsExt - ss.nBits)
    lines.append(f"""
    component lastIFFT = FFT({last}, 1);
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
    sN = starkinfo.map_sectionsN
    nq = ss.nQueries
    nbits0 = ss.steps[0].nBits
    nsib0 = (nbits0 - 1) // 4 + 1
    trees = ["1"] + [str(t) for t in (2, 3)
                     if sN.get(f"cm{t}_2ns") > 0] + ["4", "C"]
    widths = {"1": sN.get("cm1_2ns"), "2": sN.get("cm2_2ns"),
              "3": sN.get("cm3_2ns"), "4": sN.get("cm4_2ns"),
              "C": starkinfo.n_constants}
    lines = [f"""
template Main() {{
    signal input proverAddr;
    signal output publicsHash;

    signal input publics[{len(pil.publics)}];
    {"signal input rootC; " if options.verkey_input else ""}
    signal input root1;
    signal input root2;
    signal input root3;
    signal input root4;
    signal input evals[{len(starkinfo.ev_map)}][3];
    signal input s0_vals1[{nq}][{widths['1']}];"""]
    for t in (2, 3):
        if sN.get(f"cm{t}_2ns") > 0:
            lines.append(f"    signal input s0_vals{t}[{nq}][{widths[str(t)]}];")
    lines.append(f"""    signal input s0_vals4[{nq}][{widths['4']}];
    signal input s0_valsC[{nq}][{widths['C']}];
    signal input s0_siblings1[{nq}][{nsib0}][16];""")
    for t in (2, 3):
        if sN.get(f"cm{t}_2ns") > 0:
            lines.append(f"    signal input s0_siblings{t}[{nq}][{nsib0}][16];")
    lines.append(f"""    signal input s0_siblings4[{nq}][{nsib0}][16];
    signal input s0_siblingsC[{nq}][{nsib0}][16];""")
    for s in range(len(ss.steps) - 1):
        lines.append(f"    signal input s{s + 1}_root;")
    for s in range(1, len(ss.steps)):
        gsz = (1 << (ss.steps[s - 1].nBits - ss.steps[s].nBits)) * 3
        nsib = (ss.steps[s].nBits - 1) // 4 + 1
        lines.append(f"    signal input s{s}_vals[{nq}][{gsz}];")
        lines.append(f"    signal input s{s}_siblings[{nq}][{nsib}][16];")
    lines.append(f"    signal input finalPol[{1 << ss.steps[-1].nBits}][3];")
    lines.append("""
    component sv = StarkVerifier();
    sv.publics <== publics;""")
    if options.verkey_input:
        lines.append("    sv.rootC <== rootC;")
    lines.append("""    sv.root1 <== root1;
    sv.root2 <== root2;
    sv.root3 <== root3;
    sv.root4 <== root4;
    sv.evals <== evals;""")
    for name in trees:
        lines.append(f"    sv.s0_vals{name} <== s0_vals{name};")
        lines.append(f"    sv.s0_siblings{name} <== s0_siblings{name};")
    for s in range(len(ss.steps) - 1):
        lines.append(f"    sv.s{s + 1}_root <== s{s + 1}_root;")
    for s in range(1, len(ss.steps)):
        lines.append(f"    sv.s{s}_vals <== s{s}_vals;")
        lines.append(f"    sv.s{s}_siblings <== s{s}_siblings;")
    lines.append("    sv.finalPol <== finalPol;")
    n_pub = len(pil.publics)
    lines.append(f"""
    component publicsHasher = Sha256({160 + 64 * n_pub});
    component n2bProverAddr = Num2Bits(160);
    component n2bPublics[{n_pub}];
    component cmpPublics[{n_pub}];

    n2bProverAddr.in <== proverAddr;
    for (var i=0; i<160; i++) {{
        publicsHasher.in[160 - 1 -i] <== n2bProverAddr.out[i];
    }}

    var offset = 160;
    for (var i=0; i<{n_pub}; i++) {{
        n2bPublics[i] = Num2Bits(64);
        cmpPublics[i] = CompConstant64(0xFFFFFFFF00000000);
        n2bPublics[i].in <== publics[i];
        for (var j=0; j<64; j++) {{
            publicsHasher.in[offset + 64 - 1 -j] <== n2bPublics[i].out[j];
            cmpPublics[i].in[j] <== n2bPublics[i].out[j];
        }}
        cmpPublics[i].out === 0;
        offset += 64;
    }}

    component n2bPublicsHash = Bits2Num(256);
    for (var i = 0; i < 256; i++) {{
        n2bPublicsHash.in[i] <== publicsHasher.out[255-i];
    }}

    publicsHash <== n2bPublicsHash.out;
}}

component main = Main();
""")
    return "\n".join(lines)


def render_onchain(pil, const_root, ss, starkinfo, program,
                   options=None) -> str:
    """Entry (pil2circom.rs :40 dispatch for BN128/BLS12381)."""
    from .pil2circom import StarkOption
    options = options or StarkOption()
    out = _HEADER
    out += _verify_evaluations(starkinfo, program, pil, ss)
    out += _verify_query(starkinfo, program, ss)
    out += _map_values(starkinfo)
    out += _stark_verifier(starkinfo, pil, ss, int(const_root), options)
    if not options.skip_main:
        out += _main_template(starkinfo, pil, ss, options)
    else:
        out += "\n\ncomponent main = StarkVerifier();\n"
    return out
