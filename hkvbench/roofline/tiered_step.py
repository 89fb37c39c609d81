"""One training step on the tier hierarchy, `lookup_train` then
`apply_grads`, as one piece of work: the hot tier's step as
`embedding_step` counts it over the hot tier's counts, its rows in HBM;
each hot victim's full row read for the demotion; the cold locate of the
distinct hot misses; the demotion batch's locate in the cold tier, each
cold hit's score written, the victim choice over the missing pairs'
candidate cold buckets and each admitted pair's key, digest and score.
Over the host link: the full cold row of every cold hit read, the full
row of every pair the cold tier placed written."""

from hkvbench.roofline import DIGEST, KEY, SCORE, SLOTS, embedding_step, locate_bytes


def least_bytes(c: dict, config: dict) -> dict:
    full = config["width"] * 4
    hot = embedding_step.least_bytes(c, dict(config, value_tier="hbm"))["hbm"]
    cold_probe = locate_bytes({"hits": c["cold_hits"], "hits_primary": c["cold_hits_primary"]},
                              config, c["cold_probed"])
    demote = (locate_bytes({"hits": c["demote_hits"], "hits_primary": c["demote_hits_primary"]},
                           config, c["handed"])
              + c["demote_hits"] * SCORE + c["demote_miss_rows"] * SLOTS * (KEY + SCORE)
              + c["demote_admitted"] * (KEY + DIGEST + SCORE))
    return {"hbm": hot + c["evicted"] * full + cold_probe + demote,
            "link_read": c["cold_hits"] * full, "link_write": c["demoted"] * full}
