"""Launchers, as ``repro.launch``: the train, serve and prefill step
builders, the training launcher (``train``) and the batched greedy
server."""
