"""Serving N keys through the engine: `find`'s count of them in HBM
(``find.py``), and over the host link the keys in (8 bytes a key) and, out,
each key's row of `dim` floats and its found flag: a request's answer is
on the host."""

from hkvbench.roofline import FLAG, KEY, find


def least_bytes(c: dict, config: dict) -> dict:
    n = c["lanes"]
    return dict(find.least_bytes(c, config), link_read=n * KEY,
                link_write=n * (config["dim"] * 4 + FLAG))
