from die_tpu_torch.ops.convops import circular_conv, xavier_uniform_bound
from die_tpu_torch.ops.gather import gather_fields
from die_tpu_torch.ops.gaussian import central_gradient, separable_gaussian
from die_tpu_torch.ops.perlin import perlin_field
from die_tpu_torch.ops.waves import (flow_field_any, flow_time,
                                     perlin_flow_field, wave_field)

__all__ = ["central_gradient", "separable_gaussian", "circular_conv",
           "xavier_uniform_bound", "gather_fields", "perlin_field",
           "flow_time", "flow_field_any", "perlin_flow_field", "wave_field"]
