"""jamba-v0.1-52b cut to one period of 8 layers (7 Mamba, 1 attention with
GQA, MoE FFNs of 16 experts top-2 on every other layer), bf16, every
expert held on this card.  The sizes and the cut are in
``jamba-v0.1-52b.8l.json`` beside this file; the tree and the FLOPs are
the shared LM shapes' (the Mamba scan's elementwise work is not counted)."""

import lmshapes

model_config = lmshapes.model_config
make_weights = lmshapes.make_weights
request_flops = lmshapes.request_flops
