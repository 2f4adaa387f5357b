from geotransformer_tpu_torch.engine.checkpoint import CheckpointManager  # noqa: F401
from geotransformer_tpu_torch.engine.logger import create_logger  # noqa: F401
from geotransformer_tpu_torch.engine.meters import AverageMeter, SummaryBoard  # noqa: F401
from geotransformer_tpu_torch.engine.tester import Tester  # noqa: F401
from geotransformer_tpu_torch.engine.timer import Timer, TimerDict  # noqa: F401
from geotransformer_tpu_torch.engine.trainer import Trainer  # noqa: F401
