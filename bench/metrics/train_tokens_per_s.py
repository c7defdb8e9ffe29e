"""train_tokens_per_s: tokens of the training steps completed in the window
/ the window's seconds."""


def read(run):
    n = run.counts.get("train_tokens")
    return n / run.window_s if n else None
