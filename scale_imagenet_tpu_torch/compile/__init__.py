from .gate_device import build_device_gates, circuit_device_bytes, \
    device_bytes, gate_block_apply_device, gate_multihead_apply_device, \
    gate_tt_fhe_alexnet_apply_device, gate_tt_fhe_apply_device, \
    gate_ttnet_apply_device, gate_ttnet_vgg_stem_apply_device
from .gate_net import compile_block_gates, compile_multihead_gates, \
    compile_tt_fhe_gates, compile_ttnet_gates, gate_block_apply, \
    gate_multihead_apply, gate_tt_fhe_alexnet_apply, gate_tt_fhe_apply, \
    gate_ttnet_apply, gate_ttnet_vgg_stem_apply, total_gates
from .logic import cnf_with_output_literal, count_gates, \
    dimacs_from_covers, dimacs_from_minterms, minimize_packed, \
    minimize_truth_table, save_filter_artifacts
from .lut_eval import compile_tt_fhe_lut, compile_ttnet_lut, \
    lut_tt_fhe_alexnet_apply, lut_tt_fhe_apply, lut_ttnet_apply, \
    lut_ttnet_features, lut_ttnet_vgg_stem_apply
from .lut_store import LUT_FORMAT_VERSION, load_luts, params_digest, \
    save_luts
from .truth_table import block_truth_table, compile_model_truth_tables, \
    enumerate_patterns, extract_block_tables, model_block_items, table_cache
from .verilog import block_gates_to_verilog, cnf_cover_to_expr, \
    cover_to_expr, export_model_verilog

__all__ = ["build_device_gates", "circuit_device_bytes", "device_bytes",
           "gate_block_apply_device", "gate_multihead_apply_device",
           "gate_tt_fhe_alexnet_apply_device", "gate_tt_fhe_apply_device",
           "gate_ttnet_apply_device", "gate_ttnet_vgg_stem_apply_device",
           "compile_block_gates", "compile_multihead_gates",
           "compile_tt_fhe_gates", "compile_ttnet_gates", "gate_block_apply",
           "gate_multihead_apply", "gate_tt_fhe_alexnet_apply",
           "gate_tt_fhe_apply", "gate_ttnet_apply",
           "gate_ttnet_vgg_stem_apply", "total_gates",
           "cnf_with_output_literal", "count_gates", "dimacs_from_covers",
           "dimacs_from_minterms", "minimize_packed", "minimize_truth_table",
           "save_filter_artifacts", "compile_tt_fhe_lut",
           "compile_ttnet_lut", "lut_tt_fhe_alexnet_apply",
           "lut_tt_fhe_apply", "lut_ttnet_apply", "lut_ttnet_features",
           "lut_ttnet_vgg_stem_apply",
           "LUT_FORMAT_VERSION", "load_luts", "params_digest", "save_luts",
           "block_truth_table", "compile_model_truth_tables",
           "enumerate_patterns", "extract_block_tables", "model_block_items",
           "table_cache", "block_gates_to_verilog", "cnf_cover_to_expr",
           "cover_to_expr", "export_model_verilog"]
