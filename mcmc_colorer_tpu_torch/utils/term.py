"""Terminal/trace helpers (counterpart of src/utils/miscUtils.{h,cpp} and
the easylogging++ logger.conf plumbing; a copy of
``mcmc_colorer_tpu/utils/term.py``).

The reference gates TRACE-level prints behind ``g_traceLogEn`` read from a
``logger.conf`` that it auto-creates with defaults when missing
(miscUtils.cpp:5-27; main.cu:37-38).  Here the same contract: a
``logger.conf`` in the working directory (or ``MCMC_COLORER_TRACE=1``)
enables trace output; :func:`check_logger_conf` writes the default file.
ANSI color macros mirror the reference's ``TXT_*`` set (miscUtils.h:10-28).
"""

from __future__ import annotations

import os
import sys

# ANSI color escape sequences (TXT_* macros, miscUtils.h:10-28)
TXT_NORML = "\033[0m"
TXT_BIBLK = "\033[1;90m"
TXT_BIRED = "\033[1;91m"
TXT_BIGRN = "\033[1;92m"
TXT_BIYLW = "\033[1;93m"
TXT_BIBLU = "\033[1;94m"
TXT_BIPRP = "\033[1;95m"
TXT_BICYA = "\033[1;96m"
TXT_COLORS = {
    "normal": TXT_NORML,
    "red": TXT_BIRED,
    "green": TXT_BIGRN,
    "yellow": TXT_BIYLW,
    "blue": TXT_BIBLU,
    "purple": TXT_BIPRP,
    "cyan": TXT_BICYA,
}

_DEFAULT_LOGGER_CONF = """* GLOBAL:
   FORMAT               =  "%datetime %msg"
   FILENAME             =  "mcmc_colorer.log"
   ENABLED              =  true
   TO_FILE              =  true
   TO_STANDARD_OUTPUT   =  true
   PERFORMANCE_TRACKING =  false
   MAX_LOG_FILE_SIZE    =  2097152
   LOG_FLUSH_THRESHOLD  =  1
* TRACE:
   ENABLED              =  false
"""


def check_logger_conf(path: str = "logger.conf") -> str:
    """Write the default config when missing (checkLoggerConfFile,
    miscUtils.cpp:5-27); returns the path."""
    if not os.path.exists(path):
        with open(path, "w") as f:
            f.write(_DEFAULT_LOGGER_CONF)
    return path


def trace_enabled(conf_path: str = "logger.conf") -> bool:
    """The reference's ``g_traceLogEn`` gate: TRACE ENABLED in logger.conf,
    or the MCMC_COLORER_TRACE env var."""
    if os.environ.get("MCMC_COLORER_TRACE", "") not in ("", "0", "false"):
        return True
    try:
        in_trace = False
        with open(conf_path) as f:
            for line in f:
                s = line.strip()
                if s.startswith("*"):
                    in_trace = s.upper().startswith("* TRACE")
                elif in_trace and s.upper().startswith("ENABLED"):
                    return "true" in s.lower()
    except OSError:
        pass
    return False


def trace(*args, color: str | None = None, **kw) -> None:
    """TRACE-level print, gated like LOG(TRACE) in the reference."""
    if not trace_enabled():
        return
    if color and sys.stderr.isatty():
        print(
            TXT_COLORS.get(color, ""),
            *args,
            TXT_NORML,
            file=sys.stderr,
            **kw,
        )
    else:
        print(*args, file=sys.stderr, **kw)
