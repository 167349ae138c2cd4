"""Share of the positions reaching ``lm.prefill`` that are padding:
1 - prompt tokens sent / (B x S of the token batches), over the timed
waves of a traced run.  The engine left-pads each wave to its longest
prompt."""


def read(obs):
    shapes = obs["prefill_shapes"]
    if not shapes:
        return None
    return 100.0 * (1.0 - obs["timed_prompt_tokens"] / sum(b * s for b, s in shapes))
