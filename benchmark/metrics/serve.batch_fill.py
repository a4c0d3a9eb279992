"""Mean over the window's served batches of real lanes / `max_batch`, from
each result's `batch_size` (a batch of n lanes returns n results)."""


def read(ctx):
    done = [d for d in ctx.window.done if d.batch_size > 0]
    if not done:
        return None
    batches = sum(1.0 / d.batch_size for d in done)
    return 100.0 * len(done) / (batches * ctx.config["serving"]["max_batch"])
