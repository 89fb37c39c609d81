"""`find` of N keys: the keys; their digest lines and the hits' key words
(``locate_bytes``); each hit's score and its row's `dim` columns; the
outputs (rows of `dim` floats, a found flag and a score a lane)."""

from hkvbench.roofline import FLAG, KEY, SCORE, locate_bytes, split


def least_bytes(c: dict, config: dict) -> dict:
    n, h, row = c["lanes"], c["hits"], config["dim"] * 4
    hbm = n * KEY + locate_bytes(c, config, n) + h * SCORE + n * (row + FLAG + SCORE)
    return split(hbm, h * row, 0, config)
