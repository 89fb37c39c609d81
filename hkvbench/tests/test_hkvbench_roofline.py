"""The per-op byte counts against counts worked out by hand for small
batches (dim 4, a 5-column row: one optimizer column)."""

from __future__ import annotations

import pytest

from hkvbench import roofline

CONFIG = {"dim": 4, "width": 5, "buckets_per_key": 2, "value_tier": "hbm"}


def test_find_counts_every_input_and_output_byte_once():
    c = {"lanes": 10, "hits": 6, "hits_primary": 4}
    # keys 10*8; digest lines (10 primary + 6 secondary) * 128; hit key words
    # 6*8 and scores 6*8; hit rows 6 * 4*4; outputs 10 * (16 + 1 + 8)
    want = 80 + 16 * 128 + 48 + 48 + 96 + 250
    assert roofline.model("find").least_bytes(c, CONFIG) == {"hbm": want}


def test_find_single_bucket_reads_one_line_a_key():
    c = {"lanes": 10, "hits": 6, "hits_primary": 6}
    got = roofline.model("find").least_bytes(c, dict(CONFIG, buckets_per_key=1))
    assert got == {"hbm": 80 + 10 * 128 + 48 + 48 + 96 + 250}


UPSERT = {"lanes": 10, "distinct": 8, "hits": 3, "hits_primary": 2, "admitted": 4,
          "miss_rows": 7}


def test_insert_or_assign_counts_the_victim_choice_and_the_writes():
    # keys 80; the 8 winning rows 8*16; digest lines (8 + 6) * 128; hit key
    # words 24, hit scores 24; the 7 candidate rows' keys and scores 7*128*16;
    # admitted key, digest, score 4*17; statuses 10; full rows written 7*20
    want = 80 + 128 + 14 * 128 + 24 + 24 + 7 * 128 * 16 + 68 + 10 + 140
    assert roofline.model("insert_or_assign").least_bytes(UPSERT, CONFIG) == {"hbm": want}


def test_the_training_step_splits_rows_onto_the_host_link():
    c = dict(UPSERT, resident=7)
    hmem = dict(CONFIG, value_tier="hmem")
    # tokens 80, gradient rows 10*16; locate 14*128 + 24; hit scores 24; victim
    # rows 7*128*16; admitted metadata 4*17; rows out 10*16.  Over the link:
    # the 3 hits' full rows read, the 7 resident rows written.
    hbm = 80 + 160 + 14 * 128 + 24 + 24 + 7 * 128 * 16 + 68 + 160
    got = roofline.model("embedding_step").least_bytes(c, hmem)
    assert got == {"hbm": hbm, "link_read": 60, "link_write": 140}
    assert roofline.model("embedding_step").least_bytes(c, CONFIG) == {"hbm": hbm + 200}


@pytest.mark.parametrize("b,want", [
    ({"hbm": 3.35e12}, (1.0, "hbm")),
    ({"hbm": 1.0, "link_read": 64e9, "link_write": 32e9}, (1.0, "link")),
    ({"hbm": 6.7e12, "link_read": 64e9}, (2.0, "hbm")),
])
def test_least_seconds_takes_the_slower_bound(b, want):
    seconds, bound = roofline.least_seconds(b)
    assert seconds == pytest.approx(want[0]) and bound == want[1]
