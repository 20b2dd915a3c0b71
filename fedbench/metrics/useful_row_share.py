"""Rows of true examples over rows trained, in percent: each live slot
trains E epochs of its rung's width, of which E x min(n, steps x batch)
rows are the client's own examples (the client bank's padding and the
steps past a client's own are the rest)."""


def read(ctx):
    if not ctx.trained_rows:
        return None
    return 100.0 * ctx.useful_rows / ctx.trained_rows
