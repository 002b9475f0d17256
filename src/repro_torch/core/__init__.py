"""LightRidge core on PyTorch: the serving slice of the DONN framework."""
from repro_torch.core.config import DONNConfig, LayerSpec
from repro_torch.core.diffraction import Grid, intensity, transfer_function
from repro_torch.core.laser import Laser, data_to_cplex
from repro_torch.core.layers import Detector
from repro_torch.core.models import DONN, build_model
from repro_torch.core.physics import (
    PhysicsValidationError,
    PhysicsViolation,
    PhysicsWarning,
    validate_config,
)
from repro_torch.core.propagation import PropagationPlan, plan_from_config

__all__ = [
    "DONNConfig", "LayerSpec", "Grid", "intensity", "transfer_function",
    "Laser", "data_to_cplex", "Detector", "DONN", "build_model",
    "PhysicsValidationError", "PhysicsViolation", "PhysicsWarning",
    "validate_config", "PropagationPlan", "plan_from_config",
]
