"""`insert_or_assign` of N keys (U distinct): the keys and the U rows that
win their groups; locating the U keys; each hit's score and full row
written (its optimizer column zeroed); the victim choice, which reads the
keys and scores of every distinct candidate bucket of a missing key; each
admitted key's key, digest, score and full row written; a status a lane."""

from hkvbench.roofline import DIGEST, KEY, SCORE, SLOTS, STATUS, locate_bytes, split


def least_bytes(c: dict, config: dict) -> dict:
    n, u, h, a = c["lanes"], c["distinct"], c["hits"], c["admitted"]
    full = config["width"] * 4
    hbm = (n * KEY + u * config["dim"] * 4 + locate_bytes(c, config, u) + h * SCORE
           + c["miss_rows"] * SLOTS * (KEY + SCORE) + a * (KEY + DIGEST + SCORE) + n * STATUS)
    return split(hbm, 0, (h + a) * full, config)
