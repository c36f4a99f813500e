from sessionsimilaritysearch.evalharness import metrics  # noqa: F401
from sessionsimilaritysearch.evalharness.knn import (  # noqa: F401
    get_p_r,
    get_prediction_by_knn,
)
