"""decode_step_ms.eval (engine, serve/continuous.py): wall ms inside the
wrapped `step` calls of the window over the decode forwards they ran (the
delta of `engine.decode_steps`)."""


def read(run):
    spans, n = run.spans.get("step"), run.counters.get("decode_steps")
    return 1e3 * sum(spans) / n if spans and n else None
