from die_tpu_torch.models.base import (CallableModelPolicy, Policy,
                                       postprocess_action, register)
from die_tpu_torch.models.gradient import (GradientPolicy, GradientState,
                                           PhysarumPolicy)
from die_tpu_torch.models.nca import NCAPolicy, nca_layer_plan
from die_tpu_torch.models.static import BrownianPolicy, ConstPolicy

__all__ = ["Policy", "CallableModelPolicy", "postprocess_action", "register",
           "GradientPolicy", "GradientState", "PhysarumPolicy",
           "BrownianPolicy", "ConstPolicy", "NCAPolicy", "nca_layer_plan"]
