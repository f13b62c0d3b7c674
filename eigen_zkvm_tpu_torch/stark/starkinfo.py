"""StarkInfo: the PIL -> prover-program compiler.

Copy of eigen_zkvm_tpu/stark/starkinfo.py, imports pointed at the port.

Runs the same pipeline as the reference (reference: starky/src/starkinfo.rs,
starkinfo_Z.rs, starkinfo_cp_prover.rs, starkinfo_cp_ver.rs,
starkinfo_fri_prover.rs, starkinfo_fri_ver.rs, starkinfo_map.rs):

  publics -> step2 (plookup H1/H2) -> step3 (Z grand products) ->
  constraint polynomial Q -> verifier code -> FRI polynomial ->
  FRI verifier code -> memory map.

The emitted Segments are consumed column-vectorized by stark.vm — the memory
map's section/offset/size layout is preserved because it defines the Merkle
leaf layouts (and therefore every root and the Fiat-Shamir transcript).
"""
from __future__ import annotations

import sys
from dataclasses import dataclass, field

from ..ops import gl

# wide lookup tuples (the rv32 fetch folds ~143 columns) build deeply
# nested challenge-compression expressions; recursive clone/eval walks
# need headroom beyond CPython's default 1000 frames
if sys.getrecursionlimit() < 100_000:
    sys.setrecursionlimit(100_000)
from . import expressionops as E
from .starkinfo_codegen import (Code, Context, ContextF, EVIdx, Index,
                                IndexVec, Node, PolType, Section, Segment,
                                build_code, iterate_code, pil_code_gen)
from .types import PIL, Expression, PolIdentity, StarkStruct

GLOBAL_L1 = "Global.L1"

# connection-argument coset multipliers (reference: helper.rs get_ks, k = FGL
# non-residue chain seeded with 12275445934081160404)
K_SEED = 12275445934081160404


def get_ks(n: int):
    ks = [K_SEED]
    for _ in range(1, n):
        ks.append((ks[-1] * K_SEED) % gl.P_INT)
    return ks[:n]


@dataclass
class PCCTX:
    f_exp_id: int = 0
    t_exp_id: int = 0
    h1_id: int = 0
    h2_id: int = 0
    z_id: int = 0
    c1_id: int = 0
    c2_id: int = 0
    num_id: int = 0
    den_id: int = 0


@dataclass
class Program:
    publics_code: list = field(default_factory=list)
    step2prev: Segment = field(default_factory=Segment)
    step3prev: Segment = field(default_factory=Segment)
    step3: Segment = field(default_factory=Segment)
    step42ns: Segment = field(default_factory=Segment)
    step52ns: Segment = field(default_factory=Segment)
    verifier_code: Segment = field(default_factory=Segment)
    verifier_query_code: Segment = field(default_factory=Segment)


def _fold(a, b, c) -> Expression:
    """add(mul(a, b), c), the tree E.add(E.mul(a, b), c) builds, without its
    clones: the callers pass subtrees that nothing else holds (a fresh
    term, a clone of a challenge, the chain folded so far, each used
    once), so the result is the same tree.  Cloning the chain at every
    step, as E.add does, made a chain of n terms cost n^2 / 2 node copies
    (the RV32IM machine's FRI polynomial: 13 M copies, 50 s)."""
    return Expression("add", 0, None, None,
                      [Expression("mul", 0, None, None, [a, b]), c])


class StarkInfo:
    def __init__(self, pil: PIL, stark_struct: StarkStruct, global_l1=None):
        pil_deg = next(iter(pil.references.values())).polDeg
        stark_deg = 1 << stark_struct.nBits
        if stark_deg != pil_deg:
            raise ValueError("stark_deg != pil_deg")
        if stark_struct.nBitsExt != stark_struct.steps[0].nBits:
            raise ValueError("nBitsExt != steps[0].nBits")

        self.var_pol_map: list[PolType] = []
        self.pu_ctx: list[PCCTX] = []
        self.pe_ctx: list[PCCTX] = []
        self.ci_ctx: list[PCCTX] = []
        self.n_constants = pil.nConstants
        self.n_publics = len(pil.publics)
        self.exp2pol: dict = {}
        self.n_cm1 = self.n_cm2 = self.n_cm3 = self.n_cm4 = 0
        self.n_q = 0
        self.c_exp = 0
        self.ev_map: list[Node] = []
        self.fri_exp_id = 0
        self.n_exps = 0
        self.q_deg = 0
        self.q_dim = 0
        self.im_exps: dict = {}
        self.im_exps_list: list = []
        self.im_exp2cm: dict = {}
        self.qs: list = []
        self.cm_n: list = []
        self.cm_2ns: list = []
        self.tmpexp_n: list = []
        self.q_2ns: list = []
        self.f_2ns: list = []
        self.map_sections = IndexVec()
        self.map_sectionsN1 = Index()
        self.map_sectionsN3 = Index()
        self.map_sectionsN = Index()
        self.map_offsets = Index()
        self.map_deg = Index()
        self.map_total_n = 0
        self.publics = []
        self.ev_idx = EVIdx()

        program = Program()
        self._generate_public_calculators(pil, program)
        self.n_cm1 = pil.nCommitments

        ctx = Context()
        ctx2ns = Context()

        self._generate_step2(ctx, pil, program)
        self._generate_step3(ctx, pil, program, global_l1)
        self._generate_constraint_polynomial(ctx, ctx2ns, pil, stark_struct, program)

        ctx = Context()
        for k, v in self.im_exps.items():
            ctx.calculated[("exps", k)] = v
            ctx.calculated[("expsPrime", k)] = v
        self._generate_constraint_polynomial_verifier(ctx, pil, program)
        self._generate_fri_polynomial(ctx2ns, pil, program)

        ctx = Context()
        self._generate_fri_verifier(ctx, pil, program)

        self._map(pil, stark_struct, program)
        self.publics = list(pil.publics)
        self.program = program

    # ------------------------------------------------------------------
    def _generate_public_calculators(self, pil: PIL, program: Program):
        for p in list(pil.publics):
            if p.polType == "imP":
                ctx = Context()
                pil_code_gen(ctx, pil, p.polId, False, "", 0, False)
                segment = build_code(ctx, pil)
                ctx_f = ContextF(self, tmp_used=segment.tmp_used)

                def fix_ref(r, c, _pil):
                    pr = 1 if r.prime else 0
                    if r.type_ == "exp":
                        if (pr, r.id) not in c.exp_map:
                            c.exp_map[(pr, r.id)] = c.tmp_used
                            c.tmp_used += 1
                        r.prime = False
                        new_id = c.exp_map[(pr, r.id)]
                        r.type_ = "tmp"
                        r.id = new_id

                iterate_code(segment, fix_ref, ctx_f, pil)
                segment.tmp_used = ctx_f.tmp_used
                program.publics_code.append(segment)

    # ------------------------------------------------------------------
    def _generate_step2(self, ctx: Context, pil: PIL, program: Program):
        for pi in list(pil.plookupIdentities):
            u = E.challenge("u")
            def_val = E.challenge("defVal")

            t_exp = E.nop()
            for j in pi.t:
                e = E.exp(j)
                t_exp = e if E.is_nop(t_exp) else E.add(E.mul(u, t_exp), e)
            if pi.selT is not None:
                t_exp = E.sub(t_exp, def_val)
                t_exp = E.mul(t_exp, E.exp(pi.selT))
                t_exp = E.add(t_exp, def_val)
                t_exp.idQ = pil.nQ
                pil.nQ += 1
            t_exp_id = len(pil.expressions)
            t_exp.keep = True
            pil.expressions.append(t_exp)

            f_exp = E.nop()
            for j in pi.f:
                e = E.exp(j)
                f_exp = e if E.is_nop(f_exp) else E.add(E.mul(f_exp, u), e)
            if pi.selF is not None:
                f_exp = E.sub(f_exp, E.exp(t_exp_id))
                f_exp = E.mul(f_exp, E.exp(pi.selF))
                f_exp = E.add(f_exp, E.exp(t_exp_id))
                f_exp.idQ = pil.nQ
                pil.nQ += 1
            f_exp_id = len(pil.expressions)
            f_exp.keep = True
            pil.expressions.append(f_exp)

            pil_code_gen(ctx, pil, f_exp_id, False)
            pil_code_gen(ctx, pil, t_exp_id, False)

            h1_id = pil.nCommitments
            pil.nCommitments += 1
            h2_id = pil.nCommitments
            pil.nCommitments += 1
            self.pu_ctx.append(PCCTX(f_exp_id=f_exp_id, t_exp_id=t_exp_id,
                                     h1_id=h1_id, h2_id=h2_id))

        program.step2prev = build_code(ctx, pil)
        ctx.calculated.clear()
        self.n_cm2 = pil.nCommitments - self.n_cm1

    # ------------------------------------------------------------------
    def _generate_step3(self, ctx: Context, pil: PIL, program: Program, global_l1):
        l1 = global_l1 if global_l1 is not None else GLOBAL_L1
        self._generate_permutation_lc(pil)
        self._generate_plookup_z(ctx, pil, l1)
        self._generate_permutation_z(ctx, pil, l1)
        self._generate_connections_z(ctx, pil, l1)
        program.step3prev = build_code(ctx, pil)
        ctx.calculated.clear()

    def _generate_permutation_lc(self, pil: PIL):
        for pi in list(pil.permutationIdentities):
            u = E.challenge("u")
            def_val = E.challenge("defVal")
            t_exp = E.nop()
            for j in pi.t:
                e = E.exp(j)
                t_exp = e if E.is_nop(t_exp) else E.add(E.mul(u, t_exp), e)
            if pi.selT is not None:
                t_exp = E.sub(t_exp, def_val)
                t_exp = E.mul(t_exp, E.exp(pi.selT))
                t_exp = E.add(t_exp, def_val)
                t_exp.idQ = pil.nQ
                pil.nQ += 1
            t_exp_id = len(pil.expressions)
            pil.expressions.append(t_exp)

            f_exp = E.nop()
            for j in pi.f:
                e = E.exp(j)
                f_exp = e if E.is_nop(f_exp) else E.add(E.mul(f_exp, u), e)
            if pi.selF is not None:
                f_exp = E.sub(f_exp, def_val)
                f_exp = E.mul(f_exp, E.exp(pi.selF))
                f_exp = E.add(f_exp, def_val)
                f_exp.idQ = pil.nQ
                pil.nQ += 1
            f_exp_id = len(pil.expressions)
            pil.expressions.append(f_exp)

            self.pe_ctx.append(PCCTX(f_exp_id=f_exp_id, t_exp_id=t_exp_id))

    def _generate_plookup_z(self, ctx: Context, pil: PIL, global_l1: str):
        for i in range(len(pil.plookupIdentities)):
            pu = self.pu_ctx[i]
            pu.z_id = pil.nCommitments
            pil.nCommitments += 1

            h1 = E.cm(pu.h1_id)
            h2 = E.cm(pu.h2_id)
            h1p = E.cm(pu.h1_id, True)
            f = E.exp(pu.f_exp_id)
            t = E.exp(pu.t_exp_id)
            tp = E.exp(pu.t_exp_id, True)
            z = E.cm(pu.z_id)
            zp = E.cm(pu.z_id, True)

            assert global_l1 in pil.references, f"{global_l1} must be defined"
            l1 = E.const_(pil.references[global_l1].id)
            c1 = E.mul(l1, E.sub(z, E.number("1")))
            c1.deg = 2
            pu.c1_id = len(pil.expressions)
            pil.expressions.append(c1)
            pil.polIdentities.append(PolIdentity(pu.c1_id, "", 0))

            gamma = E.challenge("gamma")
            beta = E.challenge("beta")
            num_exp = E.mul(
                E.mul(E.add(f, gamma),
                      E.add(E.add(t, E.mul(tp, beta)),
                            E.mul(gamma, E.add(E.number("1"), beta)))),
                E.add(E.number("1"), beta))
            num_exp.idQ = pil.nQ
            pil.nQ += 1
            num_exp.keep = True
            pu.num_id = len(pil.expressions)
            pil.expressions.append(num_exp)

            den_exp = E.mul(
                E.add(E.add(h1, E.mul(h2, beta)),
                      E.mul(gamma, E.add(E.number("1"), beta))),
                E.add(E.add(h2, E.mul(h1p, beta)),
                      E.mul(gamma, E.add(E.number("1"), beta))))
            den_exp.idQ = pil.nQ
            pil.nQ += 1
            pu.den_id = len(pil.expressions)
            den_exp.keep = True
            pil.expressions.append(den_exp)

            num = E.exp(pu.num_id)
            den = E.exp(pu.den_id)
            c2 = E.sub(E.mul(zp, den), E.mul(z, num))
            c2.deg = 2
            pu.c2_id = len(pil.expressions)
            pil.expressions.append(c2)
            pil.polIdentities.append(PolIdentity(pu.c2_id, "", 0))

            pil_code_gen(ctx, pil, pu.num_id, False)
            pil_code_gen(ctx, pil, pu.den_id, False)

    def _generate_permutation_z(self, ctx: Context, pil: PIL, global_l1: str):
        for i in range(len(pil.permutationIdentities)):
            pe = self.pe_ctx[i]
            pe.z_id = pil.nCommitments
            pil.nCommitments += 1

            f = E.exp(pe.f_exp_id)
            t = E.exp(pe.t_exp_id)
            z = E.cm(pe.z_id)
            zp = E.cm(pe.z_id, True)

            assert global_l1 in pil.references, f"{global_l1} must be defined"
            l1 = E.const_(pil.references[global_l1].id)
            c1 = E.mul(l1, E.sub(z, E.number("1")))
            c1.deg = 2
            pe.c1_id = len(pil.expressions)
            pil.expressions.append(c1)
            pil.polIdentities.append(PolIdentity(pe.c1_id, "", 0))

            beta = E.challenge("beta")
            num_exp = E.add(f, beta)
            pe.num_id = len(pil.expressions)
            num_exp.keep = True
            pil.expressions.append(num_exp)

            den_exp = E.add(t, beta)
            pe.den_id = len(pil.expressions)
            den_exp.keep = True
            pil.expressions.append(den_exp)

            c2 = E.sub(E.mul(zp, E.exp(pe.den_id)), E.mul(z, E.exp(pe.num_id)))
            c2.deg = 2
            pe.c2_id = len(pil.expressions)
            pil.expressions.append(c2)
            pil.polIdentities.append(PolIdentity(pe.c2_id, "", 0))

            pil_code_gen(ctx, pil, pe.num_id, False)
            pil_code_gen(ctx, pil, pe.den_id, False)

    def _generate_connections_z(self, ctx: Context, pil: PIL, global_l1: str):
        for ci in list(pil.connectionIdentities):
            ci_pols = ci.pols
            ci_connections = ci.connections
            ci_ctx = PCCTX(z_id=pil.nCommitments)
            pil.nCommitments += 1

            gamma = E.challenge("gamma")
            beta = E.challenge("beta")

            num_exp = E.add(E.add(E.exp(ci_pols[0]), E.mul(beta, E.x())), gamma)
            den_exp = E.add(E.add(E.exp(ci_pols[0]),
                                  E.mul(beta, E.exp(ci_connections[0]))), gamma)
            ci_ctx.num_id = len(pil.expressions)
            num_exp.keep = True
            pil.expressions.append(num_exp)
            ci_ctx.den_id = len(pil.expressions)
            den_exp.keep = True
            pil.expressions.append(den_exp)

            ks = get_ks(len(ci_pols) - 1)
            for i in range(1, len(ci_pols)):
                num_exp = E.mul(
                    E.exp(ci_ctx.num_id),
                    E.add(E.add(E.exp(ci_pols[i]),
                                E.mul(E.mul(beta, E.number(str(ks[i - 1]))), E.x())),
                          gamma))
                num_exp.idQ = pil.nQ
                pil.nQ += 1
                den_exp = E.mul(
                    E.exp(ci_ctx.den_id),
                    E.add(E.add(E.exp(ci_pols[i]),
                                E.mul(beta, E.exp(ci_connections[i]))), gamma))
                den_exp.idQ = pil.nQ
                pil.nQ += 1
                ci_ctx.num_id = len(pil.expressions)
                pil.expressions.append(num_exp)
                ci_ctx.den_id = len(pil.expressions)
                pil.expressions.append(den_exp)

            z = E.cm(ci_ctx.z_id)
            zp = E.cm(ci_ctx.z_id, True)
            assert global_l1 in pil.references, f"{global_l1} must be defined"
            l1 = E.const_(pil.references[global_l1].id)
            c1 = E.mul(l1, E.sub(z, E.number("1")))
            c1.deg = 2
            ci_ctx.c1_id = len(pil.expressions)
            pil.expressions.append(c1)
            pil.polIdentities.append(PolIdentity(ci_ctx.c1_id, "", 0))

            c2 = E.sub(E.mul(zp, E.exp(ci_ctx.den_id)), E.mul(z, E.exp(ci_ctx.num_id)))
            c2.deg = 2
            ci_ctx.c2_id = len(pil.expressions)
            pil.expressions.append(c2)
            pil.polIdentities.append(PolIdentity(ci_ctx.c2_id, "", 0))

            pil_code_gen(ctx, pil, ci_ctx.num_id, False)
            pil_code_gen(ctx, pil, ci_ctx.den_id, False)
            self.ci_ctx.append(ci_ctx)

    # ------------------------------------------------------------------
    def _generate_constraint_polynomial(self, ctx, ctx2ns, pil, stark_struct, program):
        vc = E.challenge("vc")
        c_exp = E.nop()
        for pi in pil.polIdentities:
            e = E.exp(pi.e)
            c_exp = e if E.is_nop(c_exp) else _fold(vc.clone(), c_exp, e)

        self.q_deg = 0
        max_deg = (1 << (stark_struct.nBitsExt - stark_struct.nBits)) + 1
        for d in range(2, max_deg + 1):
            im_exps, q_deg = calculate_im_pols(pil, c_exp, d)
            if im_exps is not None and (
                self.q_deg == 0 or len(im_exps) + q_deg < len(self.im_exps) + self.q_deg
            ):
                self.q_deg = q_deg
                self.im_exps = im_exps

        self.im_exps_list = sorted(self.im_exps.keys())
        self.im_exp2cm = {}
        for exp_id in self.im_exps_list:
            self.im_exp2cm[exp_id] = pil.nCommitments
            pil.nCommitments += 1
            lhs = pil.expressions[exp_id].clone()
            rhs = Expression("cm", 0, pil.nCommitments - 1)
            e = Expression("sub", 0, None, None, [lhs, rhs])
            c_exp = e if E.is_nop(c_exp) else _fold(vc.clone(), c_exp, e)

        self.c_exp = len(pil.expressions)
        pil.expressions.append(c_exp)

        self.n_cm3 = pil.nCommitments - self.n_cm1 - self.n_cm2
        self.qs = []
        for _ in range(self.q_deg):
            self.qs.append(pil.nCommitments)
            pil.nCommitments += 1

        for exp_id in self.im_exps_list:
            pil_code_gen(ctx, pil, exp_id, False)
        program.step3 = build_code(ctx, pil)

        for k, v in self.im_exps.items():
            ctx2ns.calculated[("exps", k)] = v
            ctx2ns.calculated[("expsPrime", k)] = v
        pil_code_gen(ctx2ns, pil, self.c_exp, False)
        code = ctx2ns.code[-1].code
        code.append(Section("mul", Node("q", 0),
                            [code[-1].dest.clone(), Node("Zi", 0)]))
        program.step42ns = build_code(ctx2ns, pil)
        self.n_cm4 = self.q_deg

    # ------------------------------------------------------------------
    def _generate_constraint_polynomial_verifier(self, ctx, pil, program):
        pil_code_gen(ctx, pil, self.c_exp, False, "", 0, True)
        code = build_code(ctx, pil)
        ctx_f = ContextF(self, tmp_used=code.tmp_used)

        def fix_ref(r, c, _pil):
            p = 1 if r.prime else 0
            if r.type_ == "exp":
                if r.id in self.im_exps_list:
                    r.type_ = "cm"
                    r.id = self.im_exp2cm[r.id]
                    if self.ev_idx.get("cm", p, r.id) is None:
                        self.ev_idx.set("cm", p, r.id, len(self.ev_map))
                        self.ev_map.append(Node("cm", r.id, None, 0, r.prime, 0))
                    r.prime = False
                    r.id = self.ev_idx.get("cm", p, r.id)
                    r.type_ = "eval"
                else:
                    if (p, r.id) not in c.exp_map:
                        c.exp_map[(p, r.id)] = c.tmp_used
                        c.tmp_used += 1
                    r.type_ = "tmp"
                    r.exp_id = r.id
                    r.id = c.exp_map[(p, r.id)]
            elif r.type_ in ("cm", "const"):
                if self.ev_idx.get(r.type_, p, r.id) is None:
                    self.ev_idx.set(r.type_, p, r.id, len(self.ev_map))
                    self.ev_map.append(Node(r.type_, r.id, None, 0, r.prime, 0))
                r.prime = False
                r.id = self.ev_idx.get(r.type_, p, r.id)
                r.type_ = "eval"
            elif r.type_ in ("number", "challenge", "public", "tmp", "Z", "x", "eval"):
                pass
            else:
                raise ValueError(f"Invalid reference type: {r}")

        iterate_code(code, fix_ref, ctx_f, pil)

        for i in range(self.q_deg):
            self.ev_idx.set("cm", 0, self.qs[i], len(self.ev_map))
            self.ev_map.append(Node("cm", self.qs[i], None, 0, False, 0))

        code.tmp_used = ctx_f.tmp_used
        program.verifier_code = code

    # ------------------------------------------------------------------
    def _generate_fri_polynomial(self, ctx, pil, program):
        vf1 = E.challenge("vf1")
        vf2 = E.challenge("vf2")

        fri_exp = E.nop()
        for i in range(pil.nCommitments):
            if E.is_nop(fri_exp):
                fri_exp = E.cm(i)
            else:
                fri_exp = _fold(vf1.clone(), fri_exp, E.cm(i))

        fri1_exp = E.nop()
        fri2_exp = E.nop()
        for i, ev in enumerate(self.ev_map):
            acc = fri2_exp if ev.prime else fri1_exp
            if ev.type_ == "cm":
                e = E.cm(ev.id)
            elif ev.type_ == "q":
                e = E.q(ev.id)
            elif ev.type_ == "const":
                e = E.const_(ev.id)
            else:
                raise ValueError(f"Invalid exp op {ev.type_}")
            if not E.is_nop(acc):
                acc = _fold(acc, vf2.clone(), E.sub(e, E.eval_(i)))
            else:
                acc = E.sub(e, E.eval_(i))
            if ev.prime:
                fri2_exp = acc
            else:
                fri1_exp = acc

        if not E.is_nop(fri_exp):
            fri1_exp = E.mul(fri1_exp, E.x_div_x_sub_xi())
            fri_exp = E.add(E.mul(vf1, fri_exp), fri1_exp) if not E.is_nop(fri_exp) else fri1_exp

        if not E.is_nop(fri2_exp):
            fri2_exp = E.mul(fri2_exp, E.x_div_x_sub_wxi())
            fri_exp = E.add(E.mul(vf1, fri_exp), fri2_exp) if not E.is_nop(fri_exp) else fri2_exp

        self.fri_exp_id = len(pil.expressions)
        fri_exp.keep2ns = True
        pil.expressions.append(fri_exp)

        pil_code_gen(ctx, pil, self.fri_exp_id, False, "f", 0, False)
        code = ctx.code[-1].code
        code[-1].dest = Node("f", 0)
        program.step52ns = build_code(ctx, pil)

    # ------------------------------------------------------------------
    def _generate_fri_verifier(self, ctx, pil, program):
        pil_code_gen(ctx, pil, self.fri_exp_id, False, "", 0, True)
        code = build_code(ctx, pil)
        self.n_exps = len(pil.expressions)
        program.verifier_query_code = code

    # ------------------------------------------------------------------
    def _map(self, pil: PIL, stark_struct: StarkStruct, program: Program):
        def add_pol(pt: PolType) -> int:
            self.var_pol_map.append(pt)
            return len(self.var_pol_map) - 1

        tmpexps: dict = {}

        def im_exps_none(eid):
            return eid not in self.im_exps or not self.im_exps[eid]

        pil.cm_dims = [0] * (self.n_cm1 + self.n_cm2 + self.n_cm3 + self.n_cm4)
        for i in range(self.n_cm1):
            pp_n = add_pol(PolType("cm1_n", 0, 1, 0))
            pp_2ns = add_pol(PolType("cm1_2ns", 0, 1, 0))
            self.cm_n.append(pp_n)
            self.cm_2ns.append(pp_2ns)
            self.map_sections.cm1_n.append(pp_n)
            self.map_sections.cm1_2ns.append(pp_2ns)
            pil.cm_dims[i] = 1

        for i, pu in enumerate(self.pu_ctx):
            dim = max(get_exp_dim(pil, pil.expressions[pu.f_exp_id]),
                      get_exp_dim(pil, pil.expressions[pu.t_exp_id]))
            for off, _name in ((0, "h1"), (1, "h2")):
                pp_n = add_pol(PolType("cm2_n", 0, dim, 0))
                pp_2ns = add_pol(PolType("cm2_2ns", 0, dim, 0))
                self.cm_n.append(pp_n)
                self.cm_2ns.append(pp_2ns)
                self.map_sections.cm2_n.append(pp_n)
                self.map_sections.cm2_2ns.append(pp_2ns)
                pil.cm_dims[self.n_cm1 + i * 2 + off] = dim
            for eid in (pu.f_exp_id, pu.t_exp_id):
                if im_exps_none(eid) and eid not in tmpexps:
                    tmpexps[eid] = len(self.tmpexp_n)
                    pp = add_pol(PolType("tmpexp_n", 0, dim, 0))
                    self.tmpexp_n.append(pp)
                    self.map_sections.tmpexp_n.append(pp)
                    self.exp2pol[eid] = pp

        all_z = list(self.pu_ctx) + list(self.pe_ctx) + list(self.ci_ctx)
        for i, o in enumerate(all_z):
            ppz_n = add_pol(PolType("cm3_n", 0, 3, 0))
            ppz_2ns = add_pol(PolType("cm3_2ns", 0, 3, 0))
            self.cm_n.append(ppz_n)
            self.cm_2ns.append(ppz_2ns)
            self.map_sections.cm3_n.append(ppz_n)
            self.map_sections.cm3_2ns.append(ppz_2ns)
            pil.cm_dims[self.n_cm1 + self.n_cm2 + i] = 3
            for eid in (o.num_id, o.den_id):
                if im_exps_none(eid) and eid not in tmpexps:
                    tmpexps[eid] = len(self.tmpexp_n)
                    pp = add_pol(PolType("tmpexp_n", 0, 3, 0))
                    self.tmpexp_n.append(pp)
                    self.map_sections.tmpexp_n.append(pp)
                    self.exp2pol[eid] = pp

        for i, eid in enumerate(self.im_exps_list):
            dim = get_exp_dim(pil, pil.expressions[eid])
            ppz_n = add_pol(PolType("cm3_n", 0, dim, 0))
            ppz_2ns = add_pol(PolType("cm3_2ns", 0, dim, 0))
            self.cm_n.append(ppz_n)
            self.cm_2ns.append(ppz_2ns)
            self.map_sections.cm3_n.append(ppz_n)
            self.map_sections.cm3_2ns.append(ppz_2ns)
            # NOTE: index mirrors the reference exactly (starkinfo_map.rs:172),
            # including its overlap with the Z-poly indices above.
            pil.cm_dims[self.n_cm1 + self.n_cm2 + i] = dim
            self.exp2pol[eid] = ppz_n

        self.q_dim = get_exp_dim(pil, pil.expressions[self.c_exp])

        for i in range(self.q_deg):
            ppz_n = add_pol(PolType("cm4_n", 0, self.q_dim, 0))
            ppz_2ns = add_pol(PolType("cm4_2ns", 0, self.q_dim, 0))
            self.cm_n.append(ppz_n)
            self.cm_2ns.append(ppz_2ns)
            self.map_sections.cm4_n.append(ppz_n)
            self.map_sections.cm4_2ns.append(ppz_2ns)
            pil.cm_dims[self.n_cm1 + self.n_cm2 + self.n_cm3 + i] = self.q_dim

        self.q_2ns.append(add_pol(PolType("q_2ns", 0, self.q_dim, 0)))
        self.f_2ns.append(add_pol(PolType("f_2ns", 0, 3, 0)))

        self._map_section()
        N = 1 << stark_struct.nBits
        Next = 1 << stark_struct.nBitsExt

        mo = self.map_offsets = Index()
        mo.cm1_n = 0
        mo.cm2_n = mo.cm1_n + N * self.map_sectionsN.cm1_n
        mo.cm3_n = mo.cm2_n + N * self.map_sectionsN.cm2_n
        mo.cm4_n = mo.cm3_n + N * self.map_sectionsN.cm3_n
        mo.tmpexp_n = mo.cm4_n + N * self.map_sectionsN.cm4_n
        mo.cm1_2ns = mo.tmpexp_n + N * self.map_sectionsN.tmpexp_n
        mo.cm2_2ns = mo.cm1_2ns + Next * self.map_sectionsN.cm1_2ns
        mo.cm3_2ns = mo.cm2_2ns + Next * self.map_sectionsN.cm2_2ns
        mo.cm4_2ns = mo.cm3_2ns + Next * self.map_sectionsN.cm3_2ns
        mo.q_2ns = mo.cm4_2ns + Next * self.map_sectionsN.cm4_2ns
        mo.f_2ns = mo.q_2ns + Next * self.map_sectionsN.q_2ns
        self.map_total_n = mo.f_2ns + Next * self.map_sectionsN.f_2ns

        md = self.map_deg = Index()
        for s in ("cm1_n", "cm2_n", "cm3_n", "cm4_n", "tmpexp_n"):
            md.set(s, N)
        for s in ("cm1_2ns", "cm2_2ns", "cm3_2ns", "cm4_2ns", "q_2ns", "f_2ns"):
            md.set(s, Next)

        for seg in program.publics_code:
            self._fix_prover_code(seg, "n", pil, tmpexps)
        self._fix_prover_code(program.step2prev, "n", pil, tmpexps)
        self._fix_prover_code(program.step3prev, "n", pil, tmpexps)
        self._fix_prover_code(program.step3, "n", pil, tmpexps)
        self._fix_prover_code(program.step42ns, "2ns", pil, tmpexps)
        self._fix_prover_code(program.step52ns, "2ns", pil, tmpexps)
        self._fix_prover_code(program.verifier_query_code, "2ns", pil, tmpexps)

        def fix_tree_ref(r, c, _pil):
            if r.type_ == "cm":
                p1 = self.var_pol_map[self.cm_2ns[r.id]]
                tree = {"cm1_2ns": "tree1", "cm2_2ns": "tree2",
                        "cm3_2ns": "tree3", "cm4_2ns": "tree4"}[p1.section]
                r.type_ = tree
                r.tree_pos = p1.section_pos
                r.dim = p1.dim

        iterate_code(program.verifier_query_code, fix_tree_ref, ContextF(self), pil)

        for i in range(self.n_publics):
            if i < len(program.publics_code) and program.publics_code[i].is_some():
                self._set_code_dimensions(program.publics_code[i], 1)
        self._set_code_dimensions(program.step2prev, 1)
        self._set_code_dimensions(program.step3prev, 1)
        self._set_code_dimensions(program.step3, 1)
        self._set_code_dimensions(program.step42ns, 1)
        self._set_code_dimensions(program.step52ns, 1)
        self._set_code_dimensions(program.verifier_code, 3)
        self._set_code_dimensions(program.verifier_query_code, 1)

    def _map_section(self):
        for s in ("cm1_n", "cm1_2ns", "cm2_n", "cm2_2ns", "cm3_n", "cm3_2ns",
                  "cm4_n", "cm4_2ns", "q_2ns", "f_2ns", "tmpexp_n"):
            p = 0
            for e in (1, 2, 3):
                for pp in self.var_pol_map:
                    if pp.section == s and pp.dim == e:
                        pp.section_pos = p
                        p += e
                if e == 1:
                    self.map_sectionsN1.set(s, p)
                if e == 3:
                    self.map_sectionsN.set(s, p)
            t = (self.map_sectionsN.get(s) - self.map_sectionsN1.get(s)) // 3
            self.map_sectionsN3.set(s, t)

    def _fix_prover_code(self, segment: Segment, dom: str, pil: PIL, tmpexps: dict):
        ctx_f = ContextF(self, tmp_used=segment.tmp_used, dom=dom, tmpexps=tmpexps)

        def fix_ref(r, c, pil_):
            if r.type_ == "cm":
                r.p = self.cm_n[r.id] if c.dom == "n" else self.cm_2ns[r.id]
            elif r.type_ == "exp":
                if r.id in self.im_exps_list:
                    r.type_ = "cm"
                    r.id = self.im_exp2cm[r.id]
                elif r.id in c.tmpexps and c.dom == "n":
                    r.type_ = "tmpExp"
                    r.dim = get_exp_dim(pil_, pil_.expressions[r.id])
                    r.id = c.tmpexps[r.id]
                else:
                    p = 1 if r.prime else 0
                    if (p, r.id) not in c.exp_map:
                        c.exp_map[(p, r.id)] = c.tmp_used
                        c.tmp_used += 1
                    r.type_ = "tmp"
                    r.exp_id = r.id
                    r.id = c.exp_map[(p, r.id)]
            elif r.type_ in ("const", "number", "challenge", "public", "tmp", "Zi",
                             "xDivXSubXi", "xDivXSubWXi", "eval", "x", "q", "f", "tmpExp"):
                pass
            else:
                raise ValueError(f"Invalid reference type {r.type_}")

        iterate_code(segment, fix_ref, ctx_f, pil)
        segment.tmp_used = ctx_f.tmp_used

    # -- dimension propagation ------------------------------------------
    def _set_dim(self, r: Node, dim: int, tmp_dim: dict):
        if r.type_ == "tmp":
            tmp_dim[r.id] = dim
            r.dim = dim
        elif r.type_ in ("exp", "cm", "q", "tmpExp", "f"):
            r.dim = dim
        else:
            raise ValueError(f"Invalid reference type set {r.type_}")

    def _get_dim(self, r: Node, tmp_dim: dict, dim_x: int) -> int:
        t = r.type_
        if t == "tmp":
            d = tmp_dim[r.id]
        elif t in ("tree1", "tree2", "tree3", "tree4", "tmpExp"):
            d = r.dim
        elif t == "cm":
            d = self.var_pol_map[self.cm_2ns[r.id]].dim
        elif t == "q":
            d = self.var_pol_map[self.qs[r.id]].dim
        elif t in ("const", "number", "public", "Zi"):
            d = 1
        elif t in ("eval", "challenge", "Z"):
            d = 3
        elif t in ("xDivXSubXi", "xDivXSubWXi", "x"):
            d = dim_x
        else:
            raise ValueError(f"Invalid reference type get {t}")
        assert d != 0, "Invalid dim"
        r.dim = d
        return d

    def _set_code_dimensions(self, segment: Segment, dim_x: int):
        tmp_dim: dict = {}
        for codes in (segment.first, segment.i, segment.last):
            for c in codes:
                if c.op in ("add", "sub", "mul"):
                    new_dim = max(self._get_dim(c.src[0], tmp_dim, dim_x),
                                  self._get_dim(c.src[1], tmp_dim, dim_x))
                elif c.op == "muladd":
                    new_dim = max(self._get_dim(c.src[0], tmp_dim, dim_x),
                                  self._get_dim(c.src[1], tmp_dim, dim_x),
                                  self._get_dim(c.src[2], tmp_dim, dim_x))
                elif c.op == "copy":
                    new_dim = self._get_dim(c.src[0], tmp_dim, dim_x)
                else:
                    raise ValueError(f"Invalid op: {c.op}")
                self._set_dim(c.dest, new_dim, tmp_dim)


# ---------------------------------------------------------------------------
# constraint-degree analysis (reference: starkinfo_cp_prover.rs)

def get_exp_degree(pil: PIL, exp: Expression) -> int:
    op = exp.op
    values = exp.values or []
    if op in ("add", "sub", "addc", "mulc", "neg"):
        md = 1
        for v in values:
            d = get_exp_degree(pil, v)
            if d > md:
                md = d
        return md
    if op == "mul":
        return get_exp_degree(pil, values[0]) + get_exp_degree(pil, values[1])
    if op == "muladd":
        return max(get_exp_degree(pil, values[0]) + get_exp_degree(pil, values[1]),
                   get_exp_degree(pil, values[2]))
    if op in ("cm", "const", "x"):
        return 1
    if op == "exp":
        return get_exp_degree(pil, pil.expressions[exp.id])
    if op in ("number", "public", "challenge", "eval"):
        return 0
    raise ValueError(f"Exp op not defined: {op}")


def _calculate_im_pols(pil, exp, im_expressions, max_deg, abs_max, abs_max_d):
    """Returns (im_expressions or None, degree). abs_max_d is a 1-item list."""
    if im_expressions is None:
        return None, -1
    op = exp.op
    if op in ("add", "sub", "addc", "mulc", "neg"):
        md = 0
        im_e = dict(im_expressions)
        for v in exp.values:
            im_e, d = _calculate_im_pols(pil, v, im_e, max_deg, abs_max, abs_max_d)
            if d > md:
                md = d
        return im_e, md
    if op in ("number", "public", "challenge"):
        return dict(im_expressions), 0
    if op in ("x", "const", "cm"):
        if max_deg < 1:
            return None, -1
        return dict(im_expressions), 1
    if op == "mul":
        values = exp.values
        if values[0].op in ("number", "public", "challenge"):
            return _calculate_im_pols(pil, values[1], im_expressions, max_deg, abs_max, abs_max_d)
        if values[1].op in ("number", "public", "challenge"):
            return _calculate_im_pols(pil, values[0], im_expressions, max_deg, abs_max, abs_max_d)
        max_deg_here = get_exp_degree(pil, exp)
        if max_deg_here <= max_deg:
            return dict(im_expressions), max_deg_here
        eb, ed = None, -1
        for l in range(max_deg + 1):
            r = max_deg - l
            e1, d1 = _calculate_im_pols(pil, values[0], im_expressions, l, abs_max, abs_max_d)
            e2, d2 = _calculate_im_pols(pil, values[1], e1, r, abs_max, abs_max_d)
            if e2 is not None:
                if eb is None or len(e2) < len(eb):
                    eb, ed = e2, d1 + d2
            if eb is not None and im_expressions is not None and len(eb) == len(im_expressions):
                return eb, ed
        return eb, ed
    if op == "exp":
        if max_deg < 1:
            return None, -1
        if im_expressions is not None and exp.id in im_expressions:
            return dict(im_expressions), 1
        exp_n = pil.expressions[exp.id]
        e, d = _calculate_im_pols(pil, exp_n, im_expressions, abs_max, abs_max, abs_max_d)
        if e is None:
            return None, -1
        if d > max_deg:
            e = dict(e)
            e[exp.id] = True
            if d > abs_max_d[0]:
                abs_max_d[0] = d
            return e, 1
        return e, d
    raise ValueError(f"Exp op not defined: {op}")


def calculate_im_pols(pil: PIL, exp: Expression, max_deg: int):
    abs_max_d = [0]
    re, rd = _calculate_im_pols(pil, exp, {}, max_deg, max_deg, abs_max_d)
    return re, max(rd, abs_max_d[0]) - 1


# dimension analysis (reference: starkinfo_map.rs get_exp_dim)

def get_exp_dim(pil: PIL, exp: Expression) -> int:
    op = exp.op
    if op in ("add", "sub", "mul", "muladd", "addc", "mulc", "neg"):
        md = 1
        for v in exp.values:
            d = get_exp_dim(pil, v)
            if d > md:
                md = d
        return md
    if op == "cm":
        return pil.cm_dims[exp.id]
    if op == "const":
        return 1
    if op == "exp":
        return get_exp_dim(pil, pil.expressions[exp.id])
    if op == "q":
        return get_exp_dim(pil, pil.expressions[pil.q2exp[exp.id]])
    if op in ("number", "public"):
        return 1
    if op in ("challenge", "eval", "xDivXSubXi", "xDivXSubWXi"):
        return 3
    if op == "x":
        return 1
    raise ValueError(f"Exp op not defined: {op}")
