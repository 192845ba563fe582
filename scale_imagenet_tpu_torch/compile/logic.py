"""Logic minimization and artifact export (counterpart of
``scale_imagenet_tpu/compile/logic.py``).

``minimize_truth_table`` minimizes a function given by its minterms with the
native engine (``native/ttlogic.py``), and derives the CNF by minimizing the
complement; ``engine="sympy"`` is the reference's SOPform/POSform (sympy is
imported only then: the machine with the card has no sympy).

``cnf_with_output_literal`` is the DNF & CNF -> CNF-with-output-literal-y
rewrite of the reference's ``get_exp_with_y``:
  DNF term  (l1 & ... & lk)  ->  clause (y | ~l1 | ... | ~lk)
  CNF clause (l1 | ... | lk) ->  clause (l1 | ... | lk | ~y)
so y <-> f(x) is encodable for SAT/FHE backends.  Every artifact's text is
the JAX package's, byte for byte.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np

from ..native import count_term_gates, espresso_cover, minimize_terms, \
    pack_table_bits, terms_to_dnf, verify_cover


def minimize_truth_table(minterms, n: int, engine: str = "native") -> dict:
    """Minimization -> ``{"dnf": str, "cnf": str, "cnf_y": str}``."""
    minterms = sorted(set(int(m) for m in minterms))
    if engine == "native":
        dnf = terms_to_dnf(minimize_terms(minterms, n), n)
        comp = sorted(set(range(2 ** n)) - set(minterms))
        cnf = _terms_to_cnf(minimize_terms(comp, n), n) if comp else "True"
        return {"dnf": dnf, "cnf": cnf,
                "cnf_y": cnf_with_output_literal(dnf, cnf)}
    if engine != "sympy":
        raise ValueError(f"engine must be 'native' or 'sympy', got "
                         f"{engine!r}")
    import sympy

    syms = sympy.symbols(" ".join(f"x_{i}" for i in range(n)))
    if n == 1:
        syms = (syms,)
    dnf = str(sympy.SOPform(syms, minterms=list(minterms)))
    cnf = str(sympy.POSform(syms, minterms=list(minterms)))
    return {"dnf": dnf, "cnf": cnf,
            "cnf_y": cnf_with_output_literal(dnf, cnf)}


# scoped memo for minimize_packed (see minimize_cache below)
_MINIMIZED: dict | None = None


@contextlib.contextmanager
def minimize_cache():
    """Memoize ``minimize_packed`` for the duration of the block: a
    ``--mode compile --verilog`` run writes the artifacts AND gate-compiles
    the same filters, and espresso is the dominant cost.  Keyed on the
    packed table's bytes and n."""
    global _MINIMIZED
    prev, _MINIMIZED = _MINIMIZED, {}
    try:
        yield
    finally:
        _MINIMIZED = prev


def minimize_packed(table_bits: np.ndarray, n: int) -> dict:
    """Espresso minimization of a PACKED 2^n-bit table (the large-n path):
    ``{"terms": [(value, mask)...], "cnf_terms": [...], "gates": int}``,
    cnf_terms being the minimized complement (one CNF clause a cube, De
    Morgan).  Both covers are verified exact against their tables
    (memoized inside ``minimize_cache()``)."""
    key = (n, np.ascontiguousarray(table_bits).tobytes())
    if _MINIMIZED is not None and key in _MINIMIZED:
        return _MINIMIZED[key]
    terms = espresso_cover(table_bits, n)
    mism = verify_cover(table_bits, terms, n)
    if mism:
        raise AssertionError(f"espresso cover inexact: {mism} mismatches")
    comp_bits = pack_table_bits(
        1 - ((np.unpackbits(np.ascontiguousarray(table_bits),
                            bitorder="little")[: 1 << n])))
    cnf_terms = espresso_cover(comp_bits, n)
    mism = verify_cover(comp_bits, cnf_terms, n)
    if mism:
        raise AssertionError(f"espresso complement cover inexact: {mism} "
                             "mismatches")
    res = {"terms": terms, "cnf_terms": cnf_terms,
           "gates": count_term_gates(terms, n)}
    if _MINIMIZED is not None:
        _MINIMIZED[key] = res
    return res


def _terms_to_cnf(complement_terms, n: int) -> str:
    """CNF of f from the minimized DNF of its complement: each complement
    cube (v, m) becomes one clause of negated literals (De Morgan)."""
    if not complement_terms:
        return "True"
    clauses = []
    for value, mask in complement_terms:
        lits = []
        for i in range(n):
            bit = n - 1 - i
            if (mask >> bit) & 1:
                continue
            lits.append(("~" if (value >> bit) & 1 else "") + f"x_{i}")
        clauses.append("(" + " | ".join(lits) + ")" if len(lits) > 1
                       else (lits[0] if lits else "False"))
    return " & ".join(clauses)


def cnf_with_output_literal(dnf_str: str, cnf_str: str) -> str:
    """Tseitin-style y <-> f encoding from the minimized DNF and CNF."""
    dnf_str = str(dnf_str).replace(" ", "")
    cnf_str = str(cnf_str).replace(" ", "")
    clauses = []
    for term in dnf_str.split("|"):
        lits = term.strip("()").split("&")
        negated = [lit[1:] if lit.startswith("~") else "~" + lit
                   for lit in lits]
        clauses.append("(y | " + " | ".join(negated) + ")")
    for clause in cnf_str.split("&"):
        lits = clause.strip("()").split("|")
        clauses.append("(" + " | ".join(lits) + " | ~y)")
    return " & ".join(clauses)


def _clause(value: int, mask: int, n: int) -> list:
    """DIMACS literals of a cube's negation: pattern bit b is x_{n-1-b},
    variable n - b."""
    lits = []
    for b in range(n):
        if (mask >> b) & 1:
            continue
        var = (n - 1 - b) + 1
        lits.append(-var if (value >> b) & 1 else var)
    return lits


def dimacs_from_covers(dnf_terms, cnf_terms, n: int,
                       comment: str = "") -> str:
    """DIMACS CNF of the output-literal encoding ``y <-> f`` from the
    minimized covers.  Variables 1..n are x_0..x_{n-1}, variable n+1 is y.
    Every DNF cube contributes (y | ~cube); every complement cube (a CNF
    clause of f by De Morgan) contributes (clause | ~y)."""
    yv = n + 1
    clauses = [[yv] + _clause(v, m, n) for v, m in dnf_terms]
    clauses += [_clause(v, m, n) + [-yv] for v, m in cnf_terms]
    out = []
    if comment:
        out.append(f"c {comment}")
    out.append(f"c vars 1..{n} = x_0..x_{n - 1}; var {yv} = y <-> f(x)")
    out.append(f"p cnf {yv} {len(clauses)}")
    for c in clauses:
        out.append(" ".join(str(v) for v in c) + " 0")
    return "\n".join(out) + "\n"


def dimacs_from_minterms(minterms, n: int, comment: str = "") -> str:
    """DIMACS ``y <-> f`` straight from a minterm list, through the same
    espresso minimizer as the gate compiler, so the clauses correspond cube
    for cube to the artifacts and gate counts written beside them."""
    bits = np.zeros(1 << n, np.uint8)
    bits[list(minterms)] = 1
    dnf_terms = espresso_cover(pack_table_bits(bits), n)
    cnf_terms = espresso_cover(pack_table_bits(1 - bits), n)
    return dimacs_from_covers(dnf_terms, cnf_terms, n, comment=comment)


def count_gates(dnf_str: str) -> int:
    """Gate count of a DNF expression: one AND per &, one OR per |, one NOT
    per ~ (the same meter as ``native.count_term_gates``)."""
    s = str(dnf_str)
    return s.count("&") + s.count("|") + s.count("~")


def save_filter_artifacts(out_dir: str, block_id: int, sub_block_id: int,
                          filter_id: int, table: np.ndarray, n: int,
                          constant: float | None = None,
                          expressions: dict | None = None):
    """Write the reference-compatible artifacts: constant .npy tables,
    per-value truth-table CSVs, and expression .txt files named like the
    reference's."""
    os.makedirs(out_dir, exist_ok=True)

    if constant is not None:
        np.save(os.path.join(
            out_dir,
            f"table_outputblock_{block_id}_filter_{filter_id}"
            f"_value_{constant}_coefdefault_{constant}.npy"), table)
        with open(os.path.join(
                out_dir,
                f"table_outputblock_{block_id}_filter_{filter_id}"
                f"_coefdefault_{constant}.txt"), "w") as f:
            f.write(str(constant))
        return

    uniq = np.unique(table)
    for v in uniq[1:]:
        rows = np.nonzero(table == v)[0]
        # truth-table CSV: index, bit columns, filter-value column
        csv_path = os.path.join(
            out_dir,
            f"Truth_Table_block{block_id}_filter_{filter_id}"
            f"_coefdefault_{v}_sousblock_{sub_block_id}.csv")
        with open(csv_path, "w") as f:
            f.write("index," + ",".join(str(i) for i in range(n))
                    + f",Filter_{filter_id}_Value_{int(v)}\n")
            mask = table == v
            for idx in range(len(table)):
                bits = ((idx >> np.arange(n - 1, -1, -1)) & 1)
                f.write(f"{idx}," + ",".join(map(str, bits))
                        + f",{bool(mask[idx])}\n")
        if expressions and float(v) in expressions:
            e = expressions[float(v)]
            base = f"_block{block_id}_filter_{filter_id}_coefdefault_{v}" \
                   f"_sousblock_{sub_block_id}.txt"
            with open(os.path.join(out_dir, "DNF_expression" + base),
                      "w") as f:
                f.write(e["dnf"])
            with open(os.path.join(out_dir, "CNF_expression" + base),
                      "w") as f:
                f.write(e["cnf"])
            with open(os.path.join(
                    out_dir,
                    f"table_outputblock_{block_id}_filter_{filter_id}"
                    f"_coefdefault_{v}.txt"), "w") as f:
                f.write(e["cnf_y"])
            with open(os.path.join(out_dir,
                                   "dimacs" + base[:-4] + ".cnf"),
                      "w") as f:
                f.write(dimacs_from_minterms(
                    rows.tolist(), n,
                    comment=f"block {block_id} filter {filter_id} "
                            f"value {v}"))


def map_in_order(fn, items, threads: int | None = None) -> list:
    """``[fn(item) for item in items]`` on a pool of ``threads`` threads
    (default: the cores this process may run on; 1 runs in this thread).  The native engine
    releases the interpreter lock, so per-filter minimizations run in
    parallel; results come back in the order of ``items``, so covers, gate
    counts and artifacts are those of a sequential run."""
    items = list(items)
    if threads is None:
        threads = len(os.sched_getaffinity(0))
    if threads <= 1 or len(items) <= 1:
        return [fn(item) for item in items]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(min(threads, len(items))) as pool:
        return list(pool.map(fn, items))
