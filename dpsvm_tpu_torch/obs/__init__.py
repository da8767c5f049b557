"""Always-on serving instruments (counterpart of part of dpsvm_tpu/obs).

metrics.py holds the counters and bounded histograms that the serving
engines' snapshot() and /metrics read; export.py renders them as
OpenMetrics text and serves them over HTTP; trace.py has only ``span``,
a no-op while no trace session exists. Run logs, trace sessions and the
compile log are not ported (ROADMAP queue A item 11), so ``obs`` off its
default is refused (config.py).
"""
