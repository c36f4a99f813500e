from sessionsimilaritysearch.utils.logging import MetricLogger, RunDir  # noqa: F401
from sessionsimilaritysearch.utils.profiling import PhaseTimer, trace  # noqa: F401
from sessionsimilaritysearch.utils.sanitize import (  # noqa: F401
    assert_donates,
    assert_pure,
    debug_nans,
)
