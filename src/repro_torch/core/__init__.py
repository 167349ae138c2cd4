"""The paper's primary contribution: a compiler-integration framework for
GEMM-based DL accelerators — accelerator descriptions, extended-CoSA
scheduling, and the generated backend (configurators -> strategies ->
mappings -> executables + cycle model).

Port of ``repro.core``.
"""
