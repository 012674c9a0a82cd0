"""Ports of the experiments' TPU kernels (``experiments/`` of the JAX
package): the retired describe selects and their describe modes
(:mod:`.mldb_losers`), the hardware probes (:mod:`.probes`) and the
scripts' composed runs (:mod:`.runs`).  Nothing here is imported by the
library; importing :mod:`.mldb_losers` registers the retired modes."""
