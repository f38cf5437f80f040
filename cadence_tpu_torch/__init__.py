"""cadence-tpu on PyTorch and CUDA: batched workflow-history replay on an
NVIDIA Hopper GPU.

The port of ``cadence_tpu``'s replay main path: histories pack into dense
int32 event tensors (``ops.pack``), a hand-written CUDA kernel replays
them as a batched finite-state machine (``ops.replay_cuda``,
``ops/csrc/replay_fsm.cu``), and ``ops.dispatch`` pipelines pack, host to
device copy and replay for storm-sized streams. The history host
(``runtime.service``, ``matching``, ``client``) writes the histories and
serves decision reads through the resident serving engine (``serving``);
the frontend gateway (``frontend``, over ``visibility`` and the archival
read side ``archival``) fronts it for callers and for the replay-based
worker SDK (``worker``), and ``testing.onebox`` wires them in one
process.
It imports neither JAX nor ``cadence_tpu``: the host modules it needs are
its own copies.

Entry points take ``device=`` and default to ``"cuda"``; they raise on a
host without CUDA unless the caller passes ``device="cpu"``, where every
kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
