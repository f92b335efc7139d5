"""Launchers, as ``repro.launch``: the serve and prefill step builders and
the batched greedy server.  Training comes with a later slice."""
