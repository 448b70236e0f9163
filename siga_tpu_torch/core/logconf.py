"""log4cxx-style logging configuration (reference parity).

The reference configures log4cxx from a properties file given by `-c` /
`--log4cxx` (default `log4cxx.properties`), falling back to a basic console
config (reference src/main.cpp:56-61).  This mirrors that behavior on
Python logging: the properties grammar understood is the subset the
reference ships (reference src/log4cxx.properties):

    log4j.rootLogger=LEVEL[,APPENDER...]
    log4j.logger.<component>=LEVEL          # per-component levels
    log4j.appender.X.layout.ConversionPattern=%d %5p [%t] (%F:%L) - %m%n

Conversion-pattern tokens map to Python logging format fields; unknown
tokens are dropped.  Components obtain loggers via `get_logger(name)` —
names match the reference's per-file loggers (e.g. "OverlapBuilder",
"FMIndex", src/overlap_builder.cpp:24).
"""
from __future__ import annotations

import logging
import os
import re
import sys
from typing import Optional

_LEVELS = {
    "trace": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

_PATTERN_MAP = [
    (re.compile(r"%d(\{[^}]*\})?"), "%(asctime)s"),
    (re.compile(r"%-?\d*p"), "%(levelname)s"),
    (re.compile(r"%c(\{\d+\})?"), "%(name)s"),
    (re.compile(r"%t"), "%(threadName)s"),
    (re.compile(r"%F"), "%(filename)s"),
    (re.compile(r"%L"), "%(lineno)d"),
    (re.compile(r"%m"), "%(message)s"),
    (re.compile(r"%n"), ""),
]

_configured = False


def _translate_pattern(pattern: str) -> str:
    for rx, repl in _PATTERN_MAP:
        pattern = rx.sub(repl, pattern)
    return pattern


def configure(path: Optional[str] = None) -> None:
    """Configure logging from a log4cxx properties file; basic console
    config when the file is absent (reference src/main.cpp:56-61)."""
    global _configured
    _configured = True
    path = path or "log4cxx.properties"
    root_level = logging.INFO
    fmt = "%(asctime)s %(levelname)5s (%(name)s) - %(message)s"
    component_levels = {}
    if os.path.exists(path):
        pattern = None
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                key, _, val = line.partition("=")
                key = key.strip()
                val = val.strip()
                if key == "log4j.rootLogger":
                    lvl = val.split(",")[0].strip().lower()
                    root_level = _LEVELS.get(lvl, logging.INFO)
                elif key.startswith("log4j.logger."):
                    comp = key[len("log4j.logger."):]
                    lvl = val.split(",")[0].strip().lower()
                    component_levels[comp] = _LEVELS.get(lvl, logging.INFO)
                elif key.endswith("layout.ConversionPattern"):
                    pattern = val
        if pattern:
            fmt = _translate_pattern(pattern)
    root = logging.getLogger("siga")
    root.setLevel(root_level)
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(fmt))
    root.addHandler(handler)
    root.propagate = False
    for comp, lvl in component_levels.items():
        logging.getLogger(f"siga.{comp}").setLevel(lvl)


def get_logger(component: str) -> logging.Logger:
    """Per-component logger (reference per-file log4cxx loggers)."""
    if not _configured:
        configure()
    return logging.getLogger(f"siga.{component}")
