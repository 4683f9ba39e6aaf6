"""Device kernels launched in the traced window per unit of work (a step
or a plan): an exact count."""


def read(record, **_):
    n = record.n_kernels()
    if n == 0 or record.units <= 0:
        return None
    return n / record.units
