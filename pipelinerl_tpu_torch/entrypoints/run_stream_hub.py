"""Stream-hub job: the cross-host stream transport (``streams_tcp.py``, the
role Redis plays in the reference); host only.

    python -m pipelinerl_tpu_torch.entrypoints.run_stream_hub --config-dir=<exp>/conf --config-name=exp_config +me.port=7099

With ``streams.persist`` (the default) it mirrors every log to
``<output_dir>/streams_hub/<topic>/<instance>/<partition>.scf``; each log
keeps its last ``streams.hub_maxlen`` messages (1,000,000, the reference's
Redis ``maxlen``). It serves until SIGTERM, then writes its per-key message
and byte counts to ``<output_dir>/stream_hub/stats_stream_hub_0.json``.
"""

from __future__ import annotations

import logging
from pathlib import Path

from ..streams_tcp import StreamHub
from .common import exit_on_sigterm, load_stage_config, serve_until_terminated, stage_setup, write_stats

logger = logging.getLogger(__name__)


def main(argv: list[str] | None = None) -> None:
    cfg = load_stage_config(argv)
    exp_path = stage_setup(cfg, "stream_hub")
    exit_on_sigterm()
    persist = str(Path(exp_path) / "streams_hub") if bool(cfg.select("streams.persist", True)) else None
    maxlen = int(cfg.select("streams.hub_maxlen", 1_000_000) or 1_000_000)
    hub = StreamHub(host="0.0.0.0", port=int(cfg.select("me.port", 7099)), persist_dir=persist, maxlen=maxlen)
    hub.start()
    try:
        serve_until_terminated()
    finally:
        hub.stop()
        write_stats(cfg, {"persist_dir": persist, "keys": hub.counters()})


if __name__ == "__main__":
    main()
