"""Traffic drivers: one general generator and loop for each kind of entry
point, read by name from a traffic file's "driver" key. A driver makes the
program's objects and inputs in `setup` (warm-up included), runs one
request or training step in `step`, and hands the program's outputs that
the reference checks to `payload`."""
