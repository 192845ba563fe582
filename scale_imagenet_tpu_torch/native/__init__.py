"""The port's bindings of the native logic engine ``native/ttlogic.cpp``
and of the native image loader ``native/ttdata.cpp`` (each built at first
use into ``build/native/``; no fallback)."""

from .ttdata import NativeImageFolder, load_eval_batch
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
    "NativeImageFolder",
    "load_eval_batch",
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
