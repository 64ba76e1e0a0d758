"""``lt_shards_over_k``: shards fresh when ``asyncmap`` returned, read
from the ``repochs`` it returns, over k; the mean over the window's
epochs. 1 is the least a decode can use. Only a code whose ``nwait`` is
a decodability predicate has it: with a count of k it is 1 by
construction."""


def read(record):
    fresh = record["fresh_at_return"]
    if not fresh or not record["variable_nwait"]:
        return None
    return sum(fresh) / len(fresh) / record["k"]
