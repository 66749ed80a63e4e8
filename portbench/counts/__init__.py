"""The benchmark's arithmetic of work: model FLOPs from shapes and true
lengths (:mod:`.flops`), the published peaks of the card (:mod:`.peaks`)
and one file for each kernel's least time (its roofline bound), frozen
here so that a change to the program cannot move the yardstick."""
