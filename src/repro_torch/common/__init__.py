from repro_torch.common import hw
from repro_torch.common.pytypes import Params, PyTree
