"""The LM substrate: config, layers, KV caches, attention and the LM.

Port of ``repro.models`` for the dense family (all-attention blocks, no
MoE); the MoE, SSM, xLSTM and MLA modules wait for their slice.
"""
