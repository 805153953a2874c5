"""kube-solverd — the batch solver as a shared service.

Port of ``kubernetes_tpu/solver/``. One solver process
(``service.SolverService``, the ``cmd/solverd.py`` binary) serves solve
requests from any number of scheduler workers over a local socket
(``client.RemoteSolver``), merging concurrent waves into one batched
launch of the commit_solve kernel, one block per wave (wave coalescing).
"""
