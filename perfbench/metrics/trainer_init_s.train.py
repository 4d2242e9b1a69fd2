"""The trainer's set-up in a train cell, in s: the duration of the last
`trainer_init` span (`LdmTrainer.__init__`: the models built and moved to
the card, AdamW built, the EMA cloned), a part of `setup_s`
(perfbench/spans.py)."""

from perfbench import spans


def read(record, work):
    if record.get("kind") != "train":
        return None
    ring = spans.ring()
    inits = [s for s in ring or () if s.name == "trainer_init"
             and s.parent == 0]
    if not inits:
        return None
    return (inits[-1].end_ns - inits[-1].start_ns) / 1e9
