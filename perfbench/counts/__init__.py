"""Operations and bytes the work needs, counted from shapes: the model's
parameters (``model``), the SSD scan's forward and backward (``ssd``) and
a dense-mode decode step (``decode``), with the H100's peaks
(``peaks``)."""
