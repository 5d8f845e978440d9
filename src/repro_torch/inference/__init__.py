"""Parameters, initial-condition perturbations and the ensemble forecast
engine."""

from repro_torch.inference.engine import (  # noqa: F401
    EngineConfig,
    ForecastEngine,
    ForecastResult,
)
from repro_torch.inference.perturbations import (  # noqa: F401
    InitialConditionPerturbation,
    PerturbationConfig,
)
