"""Host seconds of the train set's Dataset.construct(). Moves setup_s."""
from benchmark.readers import construct_s as read  # noqa: F401
