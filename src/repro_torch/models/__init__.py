"""The LM substrate: config, layers, KV and MLA caches, attention, MoE,
Mamba, xLSTM and the LM.

Port of ``repro.models``: serving, and (through the flash backward and a
differentiable ``lm.forward``) training.
"""
