"""Composed entry points, torch side (the zipkin-example / tracegen mains).

The port's copy of ``zipkin_tpu/main``:

- ``zipkin_tpu_torch.main.example``: everything in one process —
  collector + device store on the card + query + HTTP API + optional
  tracegen seed (zipkin-example/.../Main.scala).
- ``zipkin_tpu_torch.main.tracegen``: generate traces, push them through
  the collector, then read them back through every query API
  (zipkin-tracegen/.../Main.scala:40-117).

Flags are argparse with the reference's names and defaults; the device
store runs on CUDA unless ``--platform cpu`` asks for the CPU.
"""
