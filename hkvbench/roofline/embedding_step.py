"""One training step, `lookup_train` then `apply_grads`, as one piece of
work: the N tokens and their gradient rows; locating the U distinct keys
once (a step that keeps the locations needs no second probe); each hit's
score; the victim choice over the missing keys' candidate buckets; each
admitted key's key, digest and score; the full rows of the hits read once
and of every resident key written once (an admitted key's init row plus
its first step); the N rows of `dim` floats handed to the model."""

from hkvbench.roofline import DIGEST, KEY, SCORE, SLOTS, locate_bytes, split


def least_bytes(c: dict, config: dict) -> dict:
    n, u, h, a = c["lanes"], c["distinct"], c["hits"], c["admitted"]
    row, full = config["dim"] * 4, config["width"] * 4
    hbm = (n * KEY + n * row + locate_bytes(c, config, u) + h * SCORE
           + c["miss_rows"] * SLOTS * (KEY + SCORE) + a * (KEY + DIGEST + SCORE) + n * row)
    return split(hbm, h * full, c["resident"] * full, config)
