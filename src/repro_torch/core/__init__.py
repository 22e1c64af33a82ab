# Percepta's stream-processing tick in PyTorch: harmonize -> anomaly ->
# gap-fill -> normalize -> aggregate -> (model) -> reward -> replay.
# See pipeline.PerceptaPipeline.
from repro_torch.core.frame import FeatureFrame, RawWindow, TickFrame  # noqa: F401
from repro_torch.core.pipeline import (PerceptaPipeline,  # noqa: F401
                                       PipelineConfig, PipelineState,
                                       init_state, run_many, tick)
