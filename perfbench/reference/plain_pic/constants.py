"""Physical constants (SI), shared by host precomputation and device code.

Values are CODATA 2018, identical to ``scipy.constants`` (which the
reference uses, e.g. FBPIC's fbpic/fields/psatd_coefs.py:9).
Hardcoded here so device-side code never imports scipy.
"""

c = 299792458.0                 # speed of light [m/s]
c2 = c * c
e = 1.602176634e-19             # elementary charge [C]
m_e = 9.1093837015e-31          # electron mass [kg]
m_p = 1.67262192369e-27         # proton mass [kg]
epsilon_0 = 8.8541878128e-12    # vacuum permittivity [F/m]
mu_0 = 1.25663706212e-06        # vacuum permeability [H/m]
k_B = 1.380649e-23              # Boltzmann constant [J/K]
hbar = 1.0545718176461565e-34   # reduced Planck constant [J.s]
