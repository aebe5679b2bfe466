"""Standard-library actor utilities — the port's counterpart of
the reference's packages/ tree (SURVEY.md §2.3).

The reference ships ~31 Pony packages. Their capabilities map here as:

  builtin            → the core framework (api/runtime/engine)
  collections        → stdlib.collections (Flags/Range/heaps/RingBuffer/
                       Sort/Reverse/List) + stdlib.persistent
                       (HAMT Map, trie Vec, cons List, Set)
  json               → stdlib.json (recursive-descent JsonDoc with
                       line-reported errors)
  cli                → stdlib.cli (CommandSpec/OptionSpec/ArgSpec typed
                       parser with sub-commands, help, env fallback)
  buffered           → stdlib.buffered (Reader/Writer chunked codecs)
  encode/base64      → stdlib.encode (configurable-alphabet Base64)
  format             → stdlib.format (Format int/float/string specs)
  itertools          → stdlib.itertools (Iter combinators)
  ini                → stdlib.ini (streaming notify parser + IniMap)
  term               → stdlib.term (ANSI codes)
  strings            → stdlib.strings (CommonPrefix)
  math               → stdlib.math (Fibonacci)
  net                → ponyc_tpu_torch.net (native socket layer underneath)
  files              → ponyc_tpu_torch.files (capability-checked)
  process            → ponyc_tpu_torch.process
  time (Timers)      → stdlib.timers (bridge timerfd underneath)
  promises           → stdlib.promises
  random             → stdlib.random (counter-based hashing, so a
                       behaviour's lanes draw independent streams with
                       no generator state, on every path: the plain
                       tick and both kernels' lane code; it replaces
                       packages/random's splittable xoroshiro)
  logger             → stdlib.logger (severity-gated, host-side)
  backpressure       → stdlib.backpressure (programmatic apply/release
                       with ApplyReleaseBackpressureAuth) on top of the
                       automatic mute/unmute machinery
  serialise          → ponyc_tpu_torch.serialise
  ponytest           → ponyc_tpu_torch.testing
  ponybench          → the port's bench (ROADMAP.md, Queue 1 item 1)
  signals            → stdlib.signals (SignalHandler/Sig) over
                       bridge.signal / bridge.sigterm_dump
  options            → config.strip_runtime_flags (runtime flags) +
                       stdlib.cli (application flags)
  bureaucracy        → stdlib.bureaucracy (Custodian incl. actor
                       dispose sends, Registrar with promise lookup)
  capsicum           → stdlib.capsicum (Cap/CapRights algebra; limit()
                       no-ops on Linux as on non-FreeBSD Pony) +
                       files.FilesAuth capability chain
  debug              → stdlib.debug (Debug.out/err, compiled away
                       unless debug-configured) + analysis dumps
  assert             → stdlib.assertion (Assert/Fact raising PonyError)
                       + config.debug_checks invariants (device)
  builtin_test,
  stdlib/_test       → tests/ (the aggregated suite IS the stdlib test
                       binary; conftest runs every package's tests)
"""

from . import (assertion, backpressure, buffered, bureaucracy,  # noqa
               capsicum, cli, collections, debug, encode, format, ini,
               itertools, json, logger, math, persistent, promises,
               random, signals, strings, term, timers)  # noqa: F401
