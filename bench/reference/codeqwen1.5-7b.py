"""Plain float32 reference of codeqwen1.5-7b as the port runs it: token
embedding, per layer RMSNorm, causal GQA with QKV bias and RoPE at
positions 0..S-1 (left padding included, unmasked), RMSNorm, a SwiGLU
MLP, then the final RMSNorm and the untied head.  ``segments`` (the
positions each engine call served) and ``routes`` change nothing in a
dense model."""

from reference import plain


def logits(weights, spec, tokens, read, segments, mm=plain.f32_mm, routes=None):
    def block(kind, p, h):
        return plain.attention(p, h, spec, mm)

    def ffn(pos, p, h):
        return plain.swiglu(p, h, mm)

    return plain.forward(weights, spec, tokens, read, block=block, ffn=ffn, mm=mm)
