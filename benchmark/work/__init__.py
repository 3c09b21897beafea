"""Work counts: the least bytes and adds a boosting iteration needs, from
its tree and its data, independent of how the program implements them."""
