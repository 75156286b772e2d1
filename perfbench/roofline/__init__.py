"""Work counters of the port's kernels: one module a kernel, named as
the per-layer metric ``<kernel>_roofline`` names it.  Each gives the
profiler's kernel name (``KERNEL``) and ``work(grid, live)``: the bytes
and float32 operations that one step's work of that kernel needs, from
the configuration's grid (physical Nz, Nr, Nm) and the live
macroparticles -- the particle quantities read or written once each,
the grid arrays read or written once each (2 Nm - 1 real values a cell
and component: mode 0 is real), never the port's slots, padding or
staging.  The same count holds whatever implements the kernel."""
