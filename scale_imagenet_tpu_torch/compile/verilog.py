"""Structural Verilog export of compiled TTnet gate circuits (counterpart of
``scale_imagenet_tpu/compile/verilog.py``; the text is the JAX package's,
byte for byte).

Every compiled Block_TT becomes one combinational Verilog module whose
per-filter ``assign`` is the verified minimal cover.  The module is the
per-window function: n window bits in, one bit per filter out; the spatial
plumbing (stride walk, pooling, head reconciliation) is instantiation
wiring, described in the manifest.  Input bit ``x[b]`` is truth-table
index bit b: window bit j = (c*kh + a)*kw + b_col maps to ``x[n-1-j]``,
and the reference's variable ``x_i`` is ``x[n-1-i]``.

Forms: ``dnf`` emits OR-of-AND covers; ``cnf`` emits AND-of-OR clauses (De
Morgan over the minimized complement, the clause set the DIMACS export
prints).  Both are bit-identical to the gate runtime.
"""

from __future__ import annotations

import json
import os

from .gate_net import BlockGates, MultiHeadGates


def _wrap(expr: str, indent: str = "      ") -> str:
    """Break a long RHS at term boundaries so the emitted file stays
    readable; Verilog is whitespace-insensitive inside expressions."""
    parts = expr.split(" | ") if " | " in expr else expr.split(" & ")
    sep = " | " if " | " in expr else " & "
    lines, cur = [], ""
    for p in parts:
        nxt = cur + (sep if cur else "") + p
        if cur and len(indent) + len(nxt) > 74:
            lines.append(cur + sep.rstrip())
            cur = p
        else:
            cur = nxt
    lines.append(cur)
    return ("\n" + indent).join(lines)


def cover_to_expr(cover, n: int, var: str = "x") -> str:
    """DNF cover -> Verilog expression (OR of AND terms).  ``cover``:
    (T, 2) (value, mask) cubes, mask bit = don't-care."""
    terms = []
    for value, mask in cover:
        value, mask = int(value), int(mask)
        lits = [f"{var}[{b}]" if (value >> b) & 1 else f"~{var}[{b}]"
                for b in range(n - 1, -1, -1) if not (mask >> b) & 1]
        terms.append("(" + " & ".join(lits) + ")" if len(lits) > 1
                     else (lits[0] if lits else "1'b1"))
    return " | ".join(terms) if terms else "1'b0"


def cnf_cover_to_expr(cnf_cover, n: int, var: str = "x") -> str:
    """Minimized complement cover -> CNF Verilog expression (AND of OR
    clauses, literals negated per De Morgan)."""
    clauses = []
    for value, mask in cnf_cover:
        value, mask = int(value), int(mask)
        lits = [f"~{var}[{b}]" if (value >> b) & 1 else f"{var}[{b}]"
                for b in range(n - 1, -1, -1) if not (mask >> b) & 1]
        clauses.append("(" + " | ".join(lits) + ")" if len(lits) > 1
                       else (lits[0] if lits else "1'b0"))
    return " & ".join(clauses) if clauses else "1'b1"


def block_gates_to_verilog(bg: BlockGates, name: str,
                           form: str = "dnf") -> str:
    """One compiled Block_TT -> one combinational Verilog module."""
    if form not in ("dnf", "cnf"):
        raise ValueError(f"form must be 'dnf' or 'cnf', got {form!r}")
    cfg = bg.cfg
    n, F = cfg.n_bits, cfg.out_planes
    kh, kw = (cfg.k, cfg.k) if isinstance(cfg.k, int) else tuple(cfg.k)
    lines = [
        f"// {name}: TTnet Block_TT as a combinational circuit "
        f"({form.upper()} form, {bg.gates} DNF-metered gates).",
        f"// {cfg.in_planes} in-planes, {F} filters, k={kh}x{kw}, "
        f"stride={cfg.stride}, groups={cfg.groupsici}; one instance per "
        "conv window.",
        "// x[b] = truth-table index bit b; window bit j = (c*kh+a)*kw+b"
        "_col",
        "// maps to x[n-1-j]; the reference's x_i is x[n-1-i].",
        f"module {name} (",
        f"    input  wire [{n - 1}:0] x,",
        f"    output wire [{F - 1}:0] y",
        ");",
    ]
    for f in range(F):
        if bg.constants[f] is not None:
            lines.append(f"  assign y[{f}] = 1'b{int(bg.constants[f])}; "
                         "// constant filter")
            continue
        expr = (cover_to_expr(bg.covers[f], n) if form == "dnf"
                else cnf_cover_to_expr(bg.cnf_covers[f], n))
        lines.append(f"  assign y[{f}] = {_wrap(expr)};")
    lines.append("endmodule")
    return "\n".join(lines) + "\n"


def export_model_verilog(gnets: list[MultiHeadGates], out_dir: str, *,
                         form: str = "dnf", model_name: str = "ttnet",
                         include_cnf: bool = False) -> dict:
    """Write one ``.v`` per compiled head/fuse block plus a manifest.

    Returns the manifest: per-module gate counts, the float parts that
    have no gate form (stem / classifier / last-fuse heads run as the
    arithmetic they are — under FHE the polynomial half of the hybrid
    scheme), and the wiring notes a netlist integrator needs.
    """
    os.makedirs(out_dir, exist_ok=True)
    manifest = {"model": model_name, "form": form, "modules": {},
                "float_parts": ["stem", "classifier"], "total_gates": 0,
                "wiring": ("spatial conv walk, avgpool-rebinarize "
                           "(sum>=2 of 4), fixup pads and channel "
                           "interleave are instantiation plumbing — see "
                           "models/multihead.py for the exact dataflow")}
    other = "cnf" if form == "dnf" else "dnf"
    forms = (form,) + ((other,) if include_cnf else ())
    for i, mg in enumerate(gnets):
        items = [(f"block{i}_conv{h}", mg.heads[h]) for h in
                 sorted(mg.heads)]
        if mg.convf is not None:
            items.append((f"block{i}_convf", mg.convf))
        else:                       # every ttnet_imagenet block fuses
            manifest["float_parts"].append(f"block{i}_convf (last/ReLU)")
        for name, bg in items:
            for fm in forms:
                fn = f"{name}.v" if fm == form else f"{name}_{fm}.v"
                with open(os.path.join(out_dir, fn), "w") as f:
                    f.write(block_gates_to_verilog(bg, name, form=fm))
            manifest["modules"][name] = {
                "file": f"{name}.v", "n_bits": bg.cfg.n_bits,
                "filters": bg.cfg.out_planes, "gates": bg.gates}
            manifest["total_gates"] += bg.gates
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest
