"""What the check reads from the timed path besides the files a job wrote:
one module a capture, named by a configuration's ``capture`` entry, with a
context manager ``capture(records_of)`` that the harness holds over the
warm-up and the window."""
