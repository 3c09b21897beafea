"""Host seconds from a train() call to its first iteration, timed once
after the window, which leaves job starts out.  Moves setup_s, whose
warm-up job starts so."""
from benchmark.readers import job_start_s as read  # noqa: F401
