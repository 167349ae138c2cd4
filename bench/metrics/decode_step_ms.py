"""Mean host-clock time of one ``lm.decode_step`` call, with a synchronise
at both ends, over the timed waves of a traced run."""


def read(obs):
    s = obs["model_call_s"]["decode_step"]
    return 1e3 * sum(s) / len(s) if s else None
