"""The paper's CNN (``cnn``, as ``repro.models.cnn``) and the scale-model
substrate's dense decoder (``layers``, ``transformer``, ``zoo``)."""
