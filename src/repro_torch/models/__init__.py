"""The LM substrate: config, layers, KV and MLA caches, attention, MoE,
Mamba, xLSTM and the LM.

Port of ``repro.models`` (the serving path; the flash backward and
training wait for their slice).
"""
