from sessionsimilaritysearch.training import losses  # noqa: F401
