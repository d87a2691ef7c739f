"""Training of the port: the CMLPL, CPS and CCT trainers and their shared
driver."""

from cmlpl_tpu_torch.train.state import CMLPLConfig, CMLPLTrainState, NetState  # noqa: F401
from cmlpl_tpu_torch.train.cmlpl import CMLPLTrainer  # noqa: F401
from cmlpl_tpu_torch.train.cps import CPSTrainer  # noqa: F401
from cmlpl_tpu_torch.train.cct import CCTTrainer  # noqa: F401
