"""DP join-order optimizer with cardinality estimation.

A host-only copy of the JAX package's module (duckdb_tpu/planner/
join_order.py), so that both packages order joins alike. The reference
enumerates join orders with a dynamic program over the query graph, costed
by estimated intermediate cardinalities (duckdb/src/optimizer/join_order/ —
query_graph.cpp, plan_enumerator.cpp, cardinality_estimator.cpp,
cost_model.cpp). This is the same idea shaped for this engine: relations
are Atoms (whole padded device columns), the cost is Cout (sum of
intermediate result rows — the quantity that drives both gather traffic
and compaction sizes on the device), and the emitted tree orients every
join with the larger side as the probe spine so dense direct-address
builds stay small.

Selectivity estimation feeds both this DP and the greedy fallback's
spine choice: pushed single-atom filters scale the atom's row estimate
by standard per-predicate factors (1/ndv for equality, range fraction
from min/max stats for inequalities — the reference's
FilterPropagateResult analog).

Bushy trees fall out naturally: joining two filtered dimensions before
the fact table wins whenever Cout says so (the hand-rolled "snowflake
collapse" special case in planner.py is subsumed when the DP runs).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from duckdb_tpu_torch.planner import bound as B
from duckdb_tpu_torch.planner import plan as P

# 3^12 subset splits ≈ 531k — still fine; beyond that greedy takes over
MAX_DP_RELATIONS = 12


# ---------------------------------------------------------------------------
# selectivity of pushed single-atom predicates

def _const_of(e: B.BoundExpr):
    try:
        if not any(isinstance(x, B.BoundColumnRef) for x in B.walk(e)):
            return e.const_value()
    except Exception:
        return None
    return None


def _col_stats(planner, atom, e: B.BoundExpr):
    if not isinstance(e, B.BoundColumnRef):
        return None
    tc = atom.col_of.get(e.key)
    if tc is None:
        return None
    try:
        return planner.catalog.get_table(tc[0]).stats_for(tc[1])
    except Exception:
        return None


def _as_float(v) -> Optional[float]:
    import datetime
    import decimal

    if isinstance(v, bool) or v is None:
        return None
    if isinstance(v, (int, float, decimal.Decimal)):
        return float(v)
    if isinstance(v, datetime.date):
        return float((v - datetime.date(1970, 1, 1)).days)
    return None


def estimate_selectivity(planner, pred: B.BoundExpr, atom) -> float:
    """Fraction of atom rows surviving this pushed predicate."""
    if isinstance(pred, B.BoundComparison):
        col, cval = None, None
        for a, b in ((pred.left, pred.right), (pred.right, pred.left)):
            c = _const_of(b)
            if isinstance(a, B.BoundColumnRef) and c is not None:
                col, cval = a, c
                break
        op = pred.op
        if op in ("=", "=="):
            st = _col_stats(planner, atom, col) if col is not None else None
            if st is not None and st.n_unique:
                return min(1.0, 1.0 / st.n_unique)
            return 0.1
        if op in ("<", "<=", ">", ">="):
            st = _col_stats(planner, atom, col) if col is not None else None
            f = _as_float(cval)
            if (st is not None and f is not None
                    and st.min_val is not None and st.max_val is not None):
                lo, hi = _as_float(st.min_val), _as_float(st.max_val)
                if lo is not None and hi is not None and hi > lo:
                    frac = (f - lo) / (hi - lo)
                    if op in (">", ">="):
                        frac = 1.0 - frac
                    if pred.right is col:  # const op col → flipped sense
                        frac = 1.0 - frac
                    return min(1.0, max(0.001, frac))
            return 1.0 / 3.0
        if op in ("!=", "<>"):
            return 0.9
        return 0.5
    if isinstance(pred, B.BoundLike):
        return 0.75 if pred.negated else 0.25
    if isinstance(pred, B.BoundInList):
        base = min(1.0, 0.1 * max(1, len(pred.items)))
        return (1.0 - base) if pred.negated else base
    if isinstance(pred, B.BoundConjunction):
        parts = [estimate_selectivity(planner, c, atom)
                 for c in pred.children()]
        if getattr(pred, "op", "and") == "or":
            s = 1.0
            for p in parts:
                s *= (1.0 - p)
            return min(1.0, max(0.0, 1.0 - s))
        s = 1.0
        for p in parts:
            s *= p
        return s
    return 0.5


# ---------------------------------------------------------------------------
# DP enumeration

def dp_join_order(planner, by_id: Dict[int, object],
                  multi: List[B.BoundExpr]) -> Optional[P.PlanNode]:
    """Order the joins of `by_id` atoms with `multi` cross-atom predicates.
    Returns the joined plan (with every predicate applied), or None when
    the DP does not apply (too many relations / disconnected graph)."""
    ids = sorted(by_id)
    n = len(ids)
    if n < 3 or n > MAX_DP_RELATIONS:
        return None
    bit = {aid: 1 << i for i, aid in enumerate(ids)}
    key2bit = {}
    for aid, a in by_id.items():
        for k in a.keys:
            key2bit[k] = bit[aid]

    def mask_of(keys: Set[str]) -> int:
        m = 0
        for k in keys:
            m |= key2bit.get(k, 0)
        return m

    edges = []   # (pred, lexpr, rexpr, lmask, rmask)
    others = []  # applied as filters once their support is joined
    for p in multi:
        if isinstance(p, B.BoundComparison) and p.op in ("=", "=="):
            lm = mask_of(planner._keys_of(p.left))
            rm = mask_of(planner._keys_of(p.right))
            if lm and rm and not (lm & rm):
                edges.append((p, p.left, p.right, lm, rm))
                continue
        others.append(p)
    if not edges:
        return None

    # ndv of a join-key expr within one side, capped by that side's card
    ndv_cache: Dict[int, Optional[float]] = {}

    def base_ndv(expr: B.BoundExpr) -> Optional[float]:
        if not isinstance(expr, B.BoundColumnRef):
            return None
        h = id(expr)
        if h in ndv_cache:
            return ndv_cache[h]
        out = None
        for a in by_id.values():
            tc = a.col_of.get(expr.key)
            if tc is not None:
                try:
                    st = planner.catalog.get_table(tc[0]).stats_for(tc[1])
                    if st.n_unique:
                        out = float(st.n_unique)
                    elif st.min_val is not None and st.max_val is not None:
                        out = float(int(st.max_val) - int(st.min_val) + 1)
                except Exception:
                    out = None
                break
        ndv_cache[h] = out
        return out

    def join_card(cl: float, cr: float, conn) -> float:
        card = cl * cr
        for (_, le, re, lm, rm, flipped) in conn:
            nl = base_ndv(le) or cl
            nr = base_ndv(re) or cr
            if flipped:
                nl, nr = nr, nl
            card /= max(min(nl, cl), min(nr, cr), 1.0)
        return max(1.0, card)

    # best[mask] = (cost, card, tree); tree = atom id | (ltree, rtree)
    best: Dict[int, Tuple[float, float, object]] = {}
    for aid in ids:
        best[bit[aid]] = (0.0, max(1.0, float(by_id[aid].rows)), aid)
    full = (1 << n) - 1

    for mask in range(3, full + 1):
        if mask & (mask - 1) == 0:
            continue  # singleton
        entry = None
        sub = (mask - 1) & mask
        while sub:
            other = mask ^ sub
            if sub > other:  # each split once; orientation chosen at emit
                le = best.get(sub)
                re_ = best.get(other)
                if le is not None and re_ is not None:
                    conn = []
                    for (p, lexpr, rexpr, lm, rm) in edges:
                        if (lm & mask) == lm and (rm & mask) == rm:
                            if (lm & sub) == lm and (rm & other) == rm:
                                conn.append((p, lexpr, rexpr, lm, rm, False))
                            elif (rm & sub) == rm and (lm & other) == lm:
                                conn.append((p, lexpr, rexpr, lm, rm, True))
                    if conn:
                        card = join_card(le[1], re_[1], conn)
                        cost = le[0] + re_[0] + card
                        if entry is None or cost < entry[0]:
                            entry = (cost, card, (le[2], re_[2]))
            sub = (sub - 1) & mask
        if entry is not None:
            best[mask] = entry
    if full not in best:
        return None  # disconnected graph → greedy handles cross joins

    # ---- emit ---------------------------------------------------------------
    used: Set[int] = set()
    pending = list(others) + [e[0] for e in edges]

    def apply_pending(plan, keys):
        nonlocal pending
        rest = []
        for p in pending:
            if id(p) in used:
                continue
            if planner._keys_of(p) <= keys:
                plan = P.Filter(plan, p)
                used.add(id(p))
            else:
                rest.append(p)
        pending = rest
        return plan

    def emit(tree):
        if not isinstance(tree, tuple):
            a = by_id[tree]
            return a.plan, set(a.keys), max(1.0, float(a.rows)), \
                max(1.0, float(getattr(a, "base_rows", 0) or a.rows))
        lp, lk, lc, lb = emit(tree[0])
        rp, rk, rc, rb = emit(tree[1])
        # probe spine = the side containing the LARGEST BASE TABLE, ties
        # broken by estimated cardinality. Estimated size alone is wrong
        # here: a selectively-filtered fact subtree can estimate smaller
        # than a dimension, but making the fact side the BUILD gives a
        # duplicate-key build (fact keys aren't unique), which the fused
        # unique-build probe pipeline cannot run — the TPU cost of losing
        # fusion dwarfs the cost of a bigger probe frame (measured: TPC-H
        # Q9 went 0.35s -> 3.8s when orders became the probe spine).
        if (rb, rc) > (lb, lc):
            lp, lk, lc, lb, rp, rk, rc, rb = rp, rk, rc, rb, lp, lk, lc, lb
        pk, bk, conn = [], [], []
        for (p, lexpr, rexpr, lm, rm) in edges:
            if id(p) in used:
                continue
            kl, kr = planner._keys_of(lexpr), planner._keys_of(rexpr)
            if kl <= lk and kr <= rk:
                pk.append(lexpr)
                bk.append(rexpr)
            elif kl <= rk and kr <= lk:
                pk.append(rexpr)
                bk.append(lexpr)
            else:
                continue
            used.add(id(p))
            conn.append((p, lexpr, rexpr, lm, rm, False))
        keys = lk | rk
        if pk:
            plan = P.Join(lp, rp, "inner", pk, bk, None)
        else:
            # no equi edge between the DP sides: spanning inequalities make
            # a keyless Join (the executor's inequality join), else a
            # CrossJoin
            conds = planner._ineq_conds_between(
                [p for p in pending if id(p) not in used], lk, rk)
            for p in conds:
                used.add(id(p))
            plan = (P.CrossJoin(lp, rp) if not conds else
                    P.Join(lp, rp, "inner", [], [], conds[0] if len(conds) == 1
                           else B.BoundConjunction("and", conds)))
        card = join_card(lc, rc, conn) if conn else lc * rc
        plan = apply_pending(plan, keys)
        return plan, keys, card, max(lb, rb)

    plan, keys, _, _ = emit(best[full][2])
    for p in pending:  # anything left (shouldn't be) — apply at the root
        if id(p) not in used:
            plan = P.Filter(plan, p)
    return plan
