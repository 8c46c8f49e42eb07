"""Operations and bytes the work needs, counted from shapes: the model's
parameters (``model``) and a dense-mode decode step (``decode``), each
handed to the configuration's family (``families/<family>.py``); the SSD
scan's forward and backward (``ssd``); the H100's peaks (``peaks``)."""
