"""The port's binding of the native logic engine ``native/ttlogic.cpp``
(built at first use into ``build/native/``; no fallback)."""

from .ttlogic import (
    count_term_gates,
    espresso_cover,
    eval_covers,
    eval_packed_table,
    expand_cover,
    minimize_terms,
    pack_table_bits,
    terms_to_dnf,
    verify_cover,
)

__all__ = [
    "count_term_gates",
    "espresso_cover",
    "eval_covers",
    "eval_packed_table",
    "expand_cover",
    "minimize_terms",
    "pack_table_bits",
    "terms_to_dnf",
    "verify_cover",
]
