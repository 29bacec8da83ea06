"""Milliseconds of the trainer's ``actor``, ``env_step`` and ``replay_add``
spans a vector step: the acting part of a step, without the learner, at
the untraced pace."""


def read(s):
    n = s.counts.get("vector_steps", 0)
    if not n or not s.spans.get("actor") or not s.untraced_s:
        return None
    return 1e3 * sum(s.plain_span_s(k) for k in
                     ("actor", "env_step", "replay_add")) / n
