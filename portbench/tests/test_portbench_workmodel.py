"""The work models against counts made by hand on a 4 x 4 cloth."""

from portbench import workmodel


def test_substeps_work_of_a_4x4_cloth():
    # springs: stretch 3 x 4 + 4 x 3, bend 2 x 4 + 4 x 2, shear 2 x 3 x 3
    cons = 12 + 12 + 8 + 8 + 18
    ops = 26 * cons + 30 * 16 + 67 * 16  # one substep of one iteration
    nbytes = 4 * (3 * 16 * 2 + 16 + 21) + 4 * 3 * 16 * 3
    assert workmodel.substeps_work([(4, 4)], 4, 4, 1, 1) == (nbytes, ops)
    # two substeps of three plain Jacobi iterations, two such cloths
    ops2 = 2 * (2 * (3 * (26 * cons + 21 * 16) + 67 * 16))
    assert workmodel.substeps_work([(4, 4)] * 2, 4, 4, 2, 3,
                                   cheb=False)[1] == ops2


def test_contacts_work_of_a_4x4_cloth():
    pairs = sum(16 - k for k in range(1, 13))  # window 12 over 16 slots
    assert pairs == 114
    nbytes = 4 * 16 * 7 + 4 * 8 + 4 * 16 * 3
    assert workmodel.contacts_work([16], 16, 12, 1) == (
        nbytes, 66 * pairs + 22 * 16)
    mesh = workmodel.contacts_work([16], 16, 12, 4, mesh=True)
    assert mesh == (4 * 16 * 10 + 4 * 8 + 4 * 16 * 3,
                    4 * (66 * pairs + 22 * 16) + 8 * pairs)


def test_bound_is_the_slower_of_bytes_and_operations():
    assert workmodel.bound_seconds(3.35e12, 0) == 1.0
    assert workmodel.bound_seconds(0, 67e12) == 1.0
    assert workmodel.bound_seconds(3.35e12, 134e12) == 2.0
