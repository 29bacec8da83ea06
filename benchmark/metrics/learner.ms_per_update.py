"""Milliseconds of the trainer's ``learner`` span a learner update: the
host's time from the first sample to the last Adam step of a vector step,
over the updates it made, at the untraced pace."""


def read(s):
    n = s.counts.get("updates", 0)
    if not n or not s.untraced_s:
        return None
    return 1e3 * s.plain_span_s("learner") / n
