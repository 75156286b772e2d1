"""User-prescribed external fields applied to particles after the gather.

Behavioral reference: FBPIC's fbpic/lpa_utils/external_fields.py.  The
step calls the user's ``field_func`` on torch tensors, on the device of
the simulation, after every gather (the linear, cubic and sorted ones).
"""


class ExternalField(object):
    """Prescribed analytical field, added to the gathered E/B per particle.

    Parameters
    ----------
    field_func: callable
        Function of the form field_func(F, x, y, z, t, amplitude,
        length_scale) returning the new per-particle field tensor F.
        F, x, y, z are torch tensors of one shape (the species' slots;
        on the resident layout the padded (Nz, K) columns, whose dead
        slots see the field harmlessly), t a 0-d tensor of the same
        dtype and device: write it with torch operations.
    fieldtype: string
        One of 'Ex','Ey','Ez','Bx','By','Bz'.
    amplitude, length_scale: floats passed through to field_func
    species: an optional SpeciesView -- restrict to one species
    """

    def __init__(self, field_func, fieldtype, amplitude, length_scale,
                 species=None):
        self.field_func = field_func
        if fieldtype not in ("Ex", "Ey", "Ez", "Bx", "By", "Bz"):
            raise ValueError("Invalid fieldtype: %s" % fieldtype)
        self.fieldtype = fieldtype
        self.amplitude = amplitude
        self.length_scale = length_scale
        self.species = species
        self.species_index = None if species is None else species._index

    def applies_to(self, species_index):
        return self.species_index is None \
            or self.species_index == species_index

    def apply(self, fields, x, y, z, t):
        """fields: dict with keys Ex..Bz of per-particle tensors."""
        F = fields[self.fieldtype]
        fields[self.fieldtype] = self.field_func(
            F, x, y, z, t, self.amplitude, self.length_scale)
        return fields
