"""Training UI of the port: stats storage, ``StatsListener``, the UI server,
its modules and the remote router.

Counterpart of ``deeplearning4j_tpu/ui/`` (the reference's
``BaseStatsListener`` → ``Persistable`` → ``StatsStorageRouter`` → storage
→ web modules pipeline, ``PlayUIServer.java:53``) as plain JSON reports
over a storage SPI served by a stdlib HTTP dashboard. Per-layer parameter
statistics are computed on the network's device and read back in one
transfer per report.
"""

from deeplearning4j_tpu_torch.ui.storage import (  # noqa: F401
    FileStatsStorage,
    InMemoryStatsStorage,
    Persistable,
    StatsStorage,
    StatsStorageEvent,
    StatsStorageListener,
    StatsStorageRouter,
)
from deeplearning4j_tpu_torch.ui.stats import (  # noqa: F401
    StatsListener,
    StatsReport,
    StatsUpdateConfiguration,
)
from deeplearning4j_tpu_torch.ui.server import RemoteReceiverModule, UIServer  # noqa: F401
from deeplearning4j_tpu_torch.ui.remote import RemoteUIStatsStorageRouter, UiConnectionInfo, WebReporter  # noqa: F401
