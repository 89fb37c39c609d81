"""The least time an op's batch can take on the card, from the bytes its
inputs and outputs need (``<op>.py``: least_bytes(counts, config)).

Published peaks of one NVIDIA H100 SXM (data sheet), which assume the
card's full 700 W; the harness prints the card's power limit beside them:
  HBM3              3.35e12 bytes/s
  PCIe Gen5 x16     64e9 bytes/s in each direction (the host link of a
                    value plane in pinned host memory)

Every byte an op's inputs need is counted once and every output byte
once, whatever a kernel reads again; data-dependent parts count what the
batch needs (hits, misses, the rows the misses' buckets hold), from the
reference's counts of the same batch.  So the share cannot pass 100% unless
the time leaves out part of the work.
"""

from __future__ import annotations

import importlib
import subprocess

HBM_BYTES_PER_S = 3.35e12
LINK_BYTES_PER_S = 64e9
SLOTS = 128
KEY, SCORE, DIGEST, STATUS, FLAG = 8, 8, 1, 1, 1


def model(op: str):
    return importlib.import_module(f"hkvbench.roofline.{op}")


def least_seconds(b: dict) -> tuple[float, str]:
    """(seconds, what bounds them) for {"hbm": bytes, "link_read": bytes,
    "link_write": bytes}: reads and writes over the link overlap."""
    times = {"hbm": b.get("hbm", 0) / HBM_BYTES_PER_S,
             "link": max(b.get("link_read", 0), b.get("link_write", 0)) / LINK_BYTES_PER_S}
    bound = max(times, key=times.get)
    return times[bound], bound


def locate_bytes(c: dict, config: dict, distinct: int) -> int:
    """Finding `distinct` keys: each key's primary digest line, the
    secondary line where the primary held no match (dual mode), and the
    key word of each hit (a digest that matches a different key is not
    counted)."""
    lines = distinct + (distinct - c["hits_primary"] if config["buckets_per_key"] == 2 else 0)
    return lines * SLOTS * DIGEST + c["hits"] * KEY


def split(hbm: int, rows_read: int, rows_written: int, config: dict) -> dict:
    """Value-row bytes go over the host link where the plane is in host
    memory, else to HBM."""
    if config["value_tier"] == "hmem":
        return {"hbm": hbm, "link_read": rows_read, "link_write": rows_written}
    return {"hbm": hbm + rows_read + rows_written}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
