"""codeqwen1.5-7b uncut: 32 dense layers of GQA (32 heads, 4 KV heads)
with QKV bias and SwiGLU, bf16, the whole model on one card.  The sizes
are in ``codeqwen1.5-7b.json`` beside this file; the tree and the FLOPs
are the shared LM shapes'."""

import lmshapes

model_config = lmshapes.model_config
make_weights = lmshapes.make_weights
request_flops = lmshapes.request_flops
