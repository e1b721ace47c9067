"""Each kernel's operations and bytes a launch, counted from its shapes, one
file a kernel (``cost/<kernel>.py``, found by name), and the whole search
step's operations (``search_step.py``). Each input byte is read once and
each output byte written once; where the work depends on the data, the
caller passes what these inputs need (distinct rows, valid slots), else
the count the shapes give. Frozen copies: the program's own ``ops.cost()``
may change without moving these."""
