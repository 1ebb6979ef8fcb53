"""Tools that set the benchmark's fixed numbers on the card: the knee
sweep that fixes a serving cell's rate (:mod:`.sweep`), and the readings
of the program, its lower-precision control and its faults that set the
limits of ``correct`` (:mod:`.calibrate`).  The benchmark's runs do not
use them."""
