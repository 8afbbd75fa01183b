"""Thread-safe deferral of capacity-overflow warnings (copy of
:mod:`pointgnn_tpu.utils.thread_warnings`).

The ``warnings`` module's filter contexts (``catch_warnings`` /
``simplefilter``) mutate process-global state, so a warning raised on a
background thread can intermittently dodge (or corrupt) a caller's
filter.  The trainer's input-prefetch thread runs host packing that
warns on overflow (``device_builder.pack_points``), so that site routes
through :func:`warn` here instead:

- on a thread inside :func:`deferred`, the (message, category) pair is
  RECORDED into a thread-local list and nothing touches the warnings
  module;
- everywhere else (direct callers, main thread) it falls through to
  ``warnings.warn`` unchanged with the same message, category, and effective
  stacklevel as before.

The thread that consumes the prefetched result calls :func:`emit` with
the recorded list, so user-visible warnings always fire on the
consuming (main) thread where filters behave deterministically.
"""

import contextlib
import threading
import warnings as _warnings
from typing import List, Tuple

_TLS = threading.local()

Entry = Tuple[str, type]


def warn(message: str, category=RuntimeWarning, stacklevel: int = 2):
    """``warnings.warn`` unless this thread is inside :func:`deferred`.

    ``stacklevel`` counts from the CALLER of this function (like a
    direct ``warnings.warn`` call would), so replacing
    ``warnings.warn(msg, cat, stacklevel=N)`` with
    ``warn(msg, cat, stacklevel=N)`` keeps the warning pointing at the
    same source line.
    """
    sink = getattr(_TLS, "sink", None)
    if sink is not None:
        sink.append((message, category))
    else:
        # +1 skips this wrapper frame
        _warnings.warn(message, category, stacklevel=stacklevel + 1)


@contextlib.contextmanager
def deferred():
    """Record this thread's :func:`warn` calls instead of emitting.

    Yields the list that accumulates ``(message, category)`` entries;
    pass it to :func:`emit` on the consuming thread.  Purely
    thread-local — concurrent threads (including the main thread's own
    direct warnings) are unaffected.
    """
    prev = getattr(_TLS, "sink", None)
    sink: List[Entry] = []
    _TLS.sink = sink
    try:
        yield sink
    finally:
        _TLS.sink = prev


def emit(entries: List[Entry], stacklevel: int = 2):
    """Re-raise deferred warnings on the calling thread.

    ``stacklevel`` counts from the caller of ``emit``, the consuming
    loop, which is the most useful source line for a warning whose
    true origin was a worker thread.
    """
    for message, category in entries:
        _warnings.warn(message, category, stacklevel=stacklevel + 1)
