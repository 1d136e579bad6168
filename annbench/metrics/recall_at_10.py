"""recall_at_10 (ratio): the mean over all answered queries of
|ids ∩ exact top-10| / 10, the exact top-10 from the reference."""


def read(run):
    if int(run.config["k"]) != 10:
        return None
    return run.recall
