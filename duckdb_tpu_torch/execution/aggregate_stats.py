"""Statistical aggregates: covariance, correlation, regression, moments,
entropy, MAD, count_if.

The JAX package's execution/aggregate_stats.py in torch. The reference
updates these per row (Welford; duckdb core_functions aggregate/algebraic
covar.hpp, corr.hpp, aggregate/regression/*.cpp, distributive/skew.cpp,
kurtosis.cpp); here, as in the JAX package, they are moment sums per group
(Σx, Σx², Σxy, Σx³, Σx⁴ in float64, and the counts in int64, which over at
most 256 groups launch the grouped-sum kernel), finished with the
reference's algebra. A pairwise aggregate skips the rows where either
argument is NULL.
"""

from __future__ import annotations

import torch

from duckdb_tpu_torch.blocks import Column
from duckdb_tpu_torch.planner import bound as B
from duckdb_tpu_torch.types import BIGINT, DOUBLE

_TWO_ARG = {
    "corr", "covar_pop", "covar_samp", "regr_slope", "regr_intercept",
    "regr_r2", "regr_count", "regr_avgx", "regr_avgy", "regr_sxx",
    "regr_syy", "regr_sxy",
}
_ONE_ARG = {"skewness", "kurtosis", "kurtosis_pop", "entropy", "sem", "mad",
            "count_if", "countif"}

STAT_AGGS = _TWO_ARG | _ONE_ARG

_EPS = torch.finfo(torch.float64).eps


def compute_stat_agg(agg, c, data, mask, grp, extra) -> Column:
    """One statistical aggregate → Column of (G,) values. mask: live rows
    whose first argument is not NULL; grp: aggregate_exec.Groups."""
    from duckdb_tpu_torch.execution.aggregate_exec import _float_of

    f = agg.func
    G, plen = grp.G, grp.plen
    if f in ("count_if", "countif"):
        # NULL over no non-NULL input, as a sum
        x = (mask & data.to(torch.bool)).to(torch.int64)
        d, n0 = grp.reduce([x, mask.to(torch.int64)], ["sum", "sum"])
        return Column(data=d, ltype=BIGINT, validity=n0 > 0)

    if f in _TWO_ARG:
        # DuckDB's argument order: f(y, x)
        xc = extra[0]
        y = _float_of(c, data)
        x = _float_of(xc, B.bcast(xc.data, plen))
        m = mask
        if xc.validity is not None:
            m = m & B.bcast(xc.validity, plen)
        gg = torch.where(m, grp.gids, G)
        xs = torch.where(m, x, 0.0)
        ys = torch.where(m, y, 0.0)
        n, sx, sy, sxx, syy, sxy = grp.reduce(
            [m.to(torch.int64), xs, ys, xs * xs, ys * ys, xs * ys], ["sum"] * 6, gg)
        nf = n.to(torch.float64)
        safe_n = nf.clamp(min=1.0)
        mx, my = sx / safe_n, sy / safe_n
        # population co-moments (the reference's co_moment state)
        cxy = sxy - sx * sy / safe_n
        cxx = sxx - sx * sx / safe_n
        cyy = syy - sy * sy / safe_n
        nonempty = n > 0
        if f == "regr_count":
            return Column(data=n, ltype=BIGINT)
        if f == "covar_pop":
            return Column(data=cxy / safe_n, ltype=DOUBLE, validity=nonempty)
        if f == "covar_samp":
            return Column(data=cxy / (nf - 1.0).clamp(min=1.0), ltype=DOUBLE, validity=n > 1)
        simple = {"regr_avgx": mx, "regr_avgy": my, "regr_sxx": cxx, "regr_syy": cyy,
                  "regr_sxy": cxy}
        if f in simple:
            return Column(data=simple[f], ltype=DOUBLE, validity=nonempty)
        var_x, var_y = cxx / safe_n, cyy / safe_n
        if f == "regr_slope":
            # one point: 0/0 → NaN, the reference's unguarded division
            return Column(data=cxy / cxx, ltype=DOUBLE, validity=nonempty)
        if f == "regr_intercept":
            slope = cxy / torch.where(cxx == 0, 1.0, cxx)
            return Column(data=my - slope * mx, ltype=DOUBLE, validity=nonempty & (var_x != 0))
        corr = (cxy / safe_n) / torch.sqrt(var_x * var_y)  # 0/0 → NaN as the reference
        if f == "corr":
            return Column(data=corr, ltype=DOUBLE, validity=nonempty)
        # regr_r2: NULL when var_pop(x) is 0, 1 when var_pop(y) is 0, else corr²
        varx_g = torch.where(n > 1, var_x, 0.0)
        vary_g = torch.where(n > 1, var_y, 0.0)
        r2 = torch.where(vary_g == 0, 1.0, corr * corr)
        return Column(data=r2, ltype=DOUBLE, validity=varx_g != 0)

    x = _float_of(c, data)
    gg = torch.where(mask, grp.gids, G)
    xs = torch.where(mask, x, 0.0)

    if f == "sem":
        n, sx, sxx = grp.reduce([mask.to(torch.int64), xs, xs * xs], ["sum"] * 3, gg)
        safe_n = n.to(torch.float64).clamp(min=1.0)
        # sqrt(population variance / n), as the reference's sem
        var_pop = (sxx - sx * sx / safe_n) / safe_n
        d = torch.sqrt(var_pop.clamp(min=0.0)) / torch.sqrt(safe_n)
        return Column(data=d, ltype=DOUBLE, validity=n > 0)

    if f == "skewness":
        n, sx, sxx, sxxx = grp.reduce(
            [mask.to(torch.int64), xs, xs * xs, xs * xs * xs], ["sum"] * 4, gg)
        nf = n.to(torch.float64)
        safe_n = nf.clamp(min=1.0)
        temp = 1.0 / safe_n
        raw_m2 = sxx - sx * sx * temp
        # second-moment noise below eps·max(1, |Σx²|) → NULL (skew.cpp)
        noise = raw_m2.abs() <= _EPS * sxx.abs().clamp(min=1.0)
        variance = temp * raw_m2
        div = torch.sqrt((variance * variance * variance).clamp(min=1e-300))
        temp1 = torch.sqrt(safe_n * (nf - 1.0).clamp(min=0.0)) / (nf - 2.0).clamp(min=1.0)
        val = temp1 * temp * (sxxx - 3 * sxx * sx * temp
                              + 2 * sx * sx * sx * temp * temp) / div
        return Column(data=val, ltype=DOUBLE, validity=(n > 2) & ~noise & (variance > 0))

    if f in ("kurtosis", "kurtosis_pop"):
        x2 = xs * xs
        n, sx, sxx, sxxx, sxxxx = grp.reduce(
            [mask.to(torch.int64), xs, x2, x2 * xs, x2 * x2], ["sum"] * 5, gg)
        nf = n.to(torch.float64)
        temp = 1.0 / nf.clamp(min=1.0)
        m4 = temp * (sxxxx - 4 * sxxx * sx * temp + 6 * sxx * sx * sx * temp * temp
                     - 3 * sx * sx * sx * sx * temp * temp * temp)
        m2 = temp * (sxx - sx * sx * temp)
        safe_m2 = torch.where(m2 == 0, 1.0, m2)
        if f == "kurtosis_pop":
            val = m4 / (safe_m2 * safe_m2) - 3.0
            ok = (n > 1) & (m2 > 0)
        else:
            val = ((nf - 1.0) * ((nf + 1.0) * m4 / (safe_m2 * safe_m2) - 3.0 * (nf - 1.0))
                   / ((nf - 2.0) * (nf - 3.0)).clamp(min=1.0))
            ok = (n > 3) & (m2 > 0)
        return Column(data=val, ltype=DOUBLE, validity=ok)

    if f == "entropy":
        # −Σ (c_v/n)·log2(c_v/n) over the per-(group, value) counts: runs of
        # the rows sorted by (group, value) (entropy.cpp)
        from duckdb_tpu_torch.execution.aggregate_exec import _key_data, run_lengths

        kd = _key_data(c, plen)
        perm, gid_s, dead_s = grp.sorted_by([torch.where(mask, kd, 0)], mask)
        kd_s = kd[perm]
        start = (gid_s != torch.roll(gid_s, 1)) | (kd_s != torch.roll(kd_s, 1))
        start[0] = True
        nf = grp.count(mask).to(torch.float64).clamp(min=1.0)
        first = start & ~dead_s  # each run counted once, at its start
        cnt_v = torch.where(first, run_lengths(start).to(torch.float64), 0.0)
        contrib = torch.where(cnt_v > 0, cnt_v * torch.log2(cnt_v.clamp(min=1.0)), 0.0)
        s_clogc = grp.reduce([contrib], ["sum"], torch.where(first, gid_s, G))[0]
        # no input gives 0.0, not NULL (entropy.cpp)
        return Column(data=(torch.log2(nf) - s_clogc / nf).clamp(min=0.0), ltype=DOUBLE)

    if f == "mad":
        # median(|x − median(x)|) per group: two quantile passes (the
        # reference's holistic MAD, quantile.cpp); DOUBLE values
        med = _group_median_f64(x, mask, grp)
        dev = (x - grp.at_rows(med)).abs()
        d = _group_median_f64(dev, mask, grp)
        return Column(data=d, ltype=DOUBLE, validity=grp.count(mask) > 0)

    raise AssertionError(f)


def _group_median_f64(x, mask, grp) -> torch.Tensor:
    """Interpolated per-group median of a float64 vector (sort-based)."""
    from duckdb_tpu_torch.execution.aggregate_exec import _decode_float_key, sorted_quantile
    from duckdb_tpu_torch.ops.sort import orderable_int64

    enc = orderable_int64(x, None, False, False)
    lo, hi, frac = sorted_quantile(enc, mask, grp, grp.count(mask), 0.5)
    lo_v = _decode_float_key(lo, torch.float64)
    hi_v = _decode_float_key(hi, torch.float64)
    return lo_v + (hi_v - lo_v) * frac
