"""Embed the user's input script in the diagnostics output."""
import sys

from .generic import OpenPMDDiagnostic, Records, _s


class InputScriptDiagnostic(OpenPMDDiagnostic):
    """Writes the text of the input script into each openPMD file."""

    def __init__(self, period=None, comm=None, write_dir=None,
                 input_script=None, dt_period=None, dt_sim=None):
        OpenPMDDiagnostic.__init__(self, period, comm, write_dir,
                                   dt_period=dt_period, dt_sim=dt_sim)
        if input_script is None:
            input_script = sys.argv[0]
        try:
            with open(input_script) as f:
                self.script_text = f.read()
        except (OSError, IOError):
            self.script_text = ""

    def collect(self, sim, iteration=None):
        if iteration is None:
            iteration = sim if isinstance(sim, int) else sim.iteration
        time = sim.time if not isinstance(sim, int) else 0.0
        dt = sim.dt if not isinstance(sim, int) else 0.0
        rec = Records()
        self.setup_openpmd_file(rec, iteration, time, dt)
        rec.group("/data/%d" % iteration)["inputScript"] = _s(
            self.script_text)
        return {"data%08d.h5" % iteration: rec}
