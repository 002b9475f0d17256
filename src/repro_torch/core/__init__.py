"""LightRidge core on PyTorch: the DONN framework's training, serving and
design slices (classify, RGB, segmentation and heterogeneous stacks; rng
codesign, batched emulation, the DSL and the DSE)."""
from repro_torch.core.config import DONNConfig, LayerSpec
from repro_torch.core.diffraction import (
    FRAUNHOFER,
    FRESNEL,
    RS,
    Grid,
    fraunhofer,
    intensity,
    propagate,
    propagate_tf,
    transfer_function,
)
from repro_torch.core.laser import Laser, data_to_cplex
from repro_torch.core.layers import Detector, DiffractiveLayer
from repro_torch.core.models import (
    DONN,
    MultiChannelDONN,
    SegmentationDONN,
    build_model,
    cached_apply,
    cached_model,
    clear_emulation_caches,
    emulate_batch,
)
from repro_torch.core.physics import (
    PhysicsValidationError,
    PhysicsViolation,
    PhysicsWarning,
    validate_config,
)
from repro_torch.core.propagation import (
    PropagationPlan,
    SegmentedPlan,
    clear_plan_cache,
    clear_tf_cache,
    plan_cache_stats,
    plan_from_config,
    tf_cache_stats,
)

__all__ = [
    "DONNConfig", "LayerSpec", "FRAUNHOFER", "FRESNEL", "RS", "Grid",
    "fraunhofer", "intensity", "propagate", "propagate_tf",
    "transfer_function",
    "Laser", "data_to_cplex", "Detector", "DiffractiveLayer", "DONN",
    "MultiChannelDONN", "SegmentationDONN", "build_model", "cached_apply",
    "cached_model", "clear_emulation_caches", "emulate_batch",
    "PhysicsValidationError", "PhysicsViolation", "PhysicsWarning",
    "validate_config", "PropagationPlan", "SegmentedPlan",
    "clear_plan_cache", "plan_cache_stats", "plan_from_config",
    "tf_cache_stats", "clear_tf_cache",
]
