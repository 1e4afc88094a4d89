"""The reference's MVCC history corpus on the port.

tests/test_mvcc_history.py (every script under
tests/testdata/mvcc_histories/: puts, deletes, range deletes,
conditional puts, increments, intents, commits and aborts over key
ranges, GC, flush, compaction and crash recovery) runs unchanged on the
port's ``MVCC`` and ``LSM`` (``reference_cases`` of test_torch_ranges.py),
each output held to the reference's golden.
"""

from tests.test_torch_ranges import reference_cases

reference_cases("test_mvcc_history.py", globals())
