"""rows_per_step.eval (engine): tokens streamed in the window over the
decode forwards the engine ran in it."""


def read(run):
    n, tokens = run.counters.get("decode_steps"), run.counters.get("tokens")
    return tokens / n if n and tokens else None
