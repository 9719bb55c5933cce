"""Configuration model of the VELOCIraptor rebuild.

The port's copy of ``velociraptor_stf_tpu/utils/config.py``, kept so that
the port imports nothing of the JAX package.

Mirrors the reference's three config layers (cf. reference ui.cxx
``GetParamFile``:295, ``ConfigCheck``:751 and the ``Options`` struct defaults in
reference allvars.h:354-848):

* an ``Options`` dataclass holding every runtime parameter, with the same
  defaults as the reference ``Options()`` constructor;
* a parser for the reference's ASCII ``key=value`` config files covering the
  full 140-keyword vocabulary of ``GetParamFile`` (verbatim keyword strings);
* ``config_check`` cross-validation mirroring ``ConfigCheck``.

The reference reads config keys with ``strtok`` on whitespace, ignores lines
starting with '#', and parses values with atoi/atof semantics (leading
numeric prefix, else 0).  We reproduce that lenient parsing so production
configs such as examples/sample_dmcosmological_run.cfg load identically.
"""

from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass, field
from typing import List, Optional

# ---------------------------------------------------------------------------
# Constants mirroring reference allvars.h
# ---------------------------------------------------------------------------

# Particle search types (allvars.h:96-104)
PSTALL = 1
PSTDARK = 2
PSTSTAR = 3
PSTGAS = 4
PSTBH = 5
PSTNOBH = 6

# Structure types (allvars.h:107-118)
HALOSTYPE = 10
HALOCORESTYPE = 5
WALLSTYPE = 1
VOIDSTYPE = 2
FILAMENTSTYPE = 3
BGTYPE = 10
GROUPNOPARENT = -1
FOF3DTYPE = 7
FOF3DGROUP = -2

# FOF search types (allvars.h:121-156)
FOFSTPROB = 1
FOFSTNOSUBSET = 2
FOF6DADAPTIVE = 3
FOF6D = 4
FOF3D = 5
FOF6DCORE = 6
FOF6DSUBSET = 7
FOFSTPROBNN = 9
FOFSTPROBLX = 10
FOFSTPROBNNLX = 11
FOFSTPROBNNNODIST = 12
FOFSTPROBSCALEELL = 13
FOFSTPROBSCALEELLNN = 14
FOFBARYON6D = 0
FOFBARYONPHASETENSOR = 1

# iterative search params (allvars.h:159-166)
MINCELLSIZE = 100
CELLSPLITNUM = 8
MINSUBSIZE = MINCELLSIZE * CELLSPLITNUM
MAXSUBLEVEL = 8
MAXCELLFRACTION = 0.1

# grid types (allvars.h:170-173)
PHYSENGRID = 1
PHASEENGRID = 2
PHYSGRID = 3

# background velocity field interpolation cells (allvars.h:185)
MAXNGRID = 6

# input types (allvars.h:188-195)
IOGADGET = 1
IOHDF = 2
IOTIPSY = 3
IORAMSES = 4
IONCHILADA = 5

# output format types (allvars.h:199-203)
OUTASCII = 0
OUTBINARY = 1
OUTHDF = 2
OUTADIOS = 3

# unbinding (allvars.h:208-230)
UNBINDNUM = 150
USYSANDPART = 0
UPART = 1
CMVELREF = 0
POTREF = 1
PROPREFCM = 0
PROPREFMBP = 1
PROPREFMINPOT = 2

# profile normalisation / bin types (allvars.h, profile defines)
PROFILERNORMR200CRIT = 0
PROFILERNORMPHYS = 1
PROFILERBINTYPELOG = 0
PROFILERBINTYPELIN = 1

# particle types (gadget ordering)
GASTYPE = 0
DARKTYPE = 1
DARK2TYPE = 2
DARK3TYPE = 3
STARTYPE = 4
BHTYPE = 5
WINDTYPE = 6
TRACERTYPE = 7
NPARTTYPES = 8


def _atoi(s: str) -> int:
    """C atoi semantics: parse leading integer, else 0."""
    s = s.strip()
    out = ""
    for i, ch in enumerate(s):
        if ch in "+-" and i == 0:
            out += ch
        elif ch.isdigit():
            out += ch
        else:
            break
    try:
        return int(out)
    except ValueError:
        return 0


def _atof(s: str) -> float:
    """C atof semantics: parse leading float, else 0."""
    s = s.strip()
    n = len(s)
    for end in range(n, 0, -1):
        try:
            return float(s[:end])
        except ValueError:
            continue
    return 0.0


def _floatlist(s: str) -> List[float]:
    """Parse the reference's comma-terminated lists: ``10,100,``."""
    return [float(tok) for tok in s.split(",") if tok.strip() != ""]


@dataclass
class UnbindInfo:
    """Unbinding parameters (reference allvars.h:280-330 ``UnbindInfo``)."""

    unbindflag: int = 0
    bgpot: int = 1
    unbindtype: int = UPART
    cmvelreftype: int = CMVELREF
    icalculatepotential: bool = True
    Eratio: float = 1.0
    minEfrac: float = 1.0
    cmdelta: float = 0.02
    maxunbindfrac: float = 0.5
    maxunboundfracforiterativeunbind: float = 0.95
    maxallowedunboundfrac: float = 0.025
    Npotref: int = 20
    fracpotref: float = 1.0
    BucketSize: int = 8
    TreeThetaOpen: float = 0.5
    eps: float = 0.0


@dataclass
class PropInfo:
    """Property-calculation parameters (reference allvars.h:334-345)."""

    cmfrac: float = 0.1
    cmadjustfac: float = 0.7


@dataclass
class Options:
    """All runtime options; defaults mirror reference ``Options()``
    (allvars.h:658-848)."""

    # file names
    fname: Optional[str] = None       # input snapshot
    outname: Optional[str] = None     # output base name
    smname: Optional[str] = None      # velocity-density cache name
    pname: Optional[str] = None       # config file name

    # input
    inputtype: int = IOGADGET
    num_files: int = 1
    snum: int = 0
    nsnapread: int = 1
    inputbufsize: int = 100000
    icosmologicalin: int = 1
    ihdfnameconvention: int = -1
    iusedmparticles: int = 1
    iusegasparticles: int = 1
    iusestarparticles: int = 1
    iusesinkparticles: int = 1
    iusewindparticles: int = 0
    iusetracerparticles: int = 0
    iuseextradarkparticles: int = 0
    gnsphblocks: int = 4
    gnstarblocks: int = 2
    gnbhblocks: int = 2
    ramsessnapname: str = ""   # reference -t flag (ui.cxx:58)

    # output
    iseparatefiles: int = 0
    ibinaryout: int = OUTASCII
    iextendedoutput: int = 0
    iextrahalooutput: int = 0
    iextragasoutput: int = 0
    iextrastaroutput: int = 0
    iextrabhoutput: int = 0
    iextrainterloperoutput: int = 0
    isubfindproperties: int = 0
    isubfindoutput: int = 0
    inoidoutput: int = 0
    icomoveunit: int = 0
    iwritefof: int = 0
    iverbose: int = 0
    snapshotvalue: int = 0
    iSphericalOverdensityPartList: int = 0

    # units
    lengthinputconversion: float = 1.0
    massinputconversion: float = 1.0
    velocityinputconversion: float = 1.0
    energyinputconversion: float = 1.0
    SFRinputconversion: float = 1.0
    metallicityinputconversion: float = 1.0
    stellarageinputconversion: float = 1.0
    istellaragescalefactor: int = 1
    isfrisssfr: int = 0
    G: float = 1.0
    MassValue: float = 1.0
    lengthtokpc: float = -1.0
    velocitytokms: float = -1.0
    masstosolarmass: float = -1.0
    SFRtosolarmassperyear: float = -1.0
    stellaragetoyrs: float = -1.0
    metallicitytosolar: float = -1.0

    # cosmology
    p: float = 0.0                    # period
    a: float = 1.0
    H: float = 100.0                  # Hubble unit, km/s/Mpc per h
    h: float = 1.0
    Omega_m: float = 1.0
    Omega_Lambda: float = 0.0
    Omega_b: float = 0.0
    Omega_cdm: float = 1.0
    Omega_k: float = 0.0
    Omega_r: float = 0.0
    Omega_nu: float = 0.0
    Omega_de: float = 0.0
    w_de: float = -1.0
    rhocrit: float = 1.0
    rhobg: float = 1.0
    virlevel: float = -1.0
    virBN98: float = 0.0
    comove: int = 0

    # local density estimation
    iLocalVelDenApproxCalcFlag: int = 1
    Bsize: int = 32
    Nvel: int = 32
    Nsearch: int = 256
    Ncell: int = 0
    Ncellfac: float = 0.01

    # group sizes
    MinSize: int = 20
    HaloMinSize: int = -1
    siglevel: float = 2.0

    # search configuration
    iSubSearch: int = 1
    foftype: int = FOFSTPROB
    fofbgtype: int = FOF6D
    gridtype: int = PHYSENGRID
    partsearchtype: int = PSTALL
    iBaryonSearch: int = 0
    ifofbaryonsearch: int = FOFBARYON6D
    icmrefadjust: int = 1
    iIterateCM: int = 1
    iSortByBindingEnergy: int = 1
    # repo extension (no reference keyword): reproduce the reference's
    # FOF6D uniform-velocity-scale accumulation bug (search.cxx:450,
    # mtotregion sums one stray particle) for catalog-compat testing
    iVscaleReferenceBugCompat: int = 0
    # reference HALOONLYDEN compile mode: per-structure velocity density
    # instead of the default one global calculation (search.cxx:2646)
    iHaloLocalDensity: int = 0
    iPropertyReferencePosition: int = PROPREFCM
    ParticleTypeForRefenceFrame: int = -1
    idenvflag: int = 0

    # linking parameters
    ellthreshold: float = 1.5
    thetaopen: float = 0.05
    Vratio: float = 1.25
    ellphys: float = 0.2
    ellvel: float = 0.5
    ellxscale: float = 1.0
    ellvscale: float = 1.0
    ellhalophysfac: float = 1.0
    ellhalovelfac: float = 1.0
    ellhalo3dxfac: float = -1.0
    ellhalo6dxfac: float = 1.0
    ellhalo6dvfac: float = 1.25

    # iterative search
    iiterflag: int = 0
    ellfac: float = 2.5
    ellxfac: float = 3.0
    vfac: float = 1.0
    thetafac: float = 1.0
    nminfac: float = 0.5
    fmerge: float = 0.25

    # halo merger / misc
    HaloMergerSize: float = 10000
    HaloMergerRatio: float = 0.2
    HaloSigmaV: float = 0.0
    HaloVelDispScale: float = 0.0
    HaloLocalSigmaV: float = 0.0
    fmergebg: float = 0.5
    iSingleHalo: int = 0
    # reference default (allvars.h:747): field halos are NOT themselves
    # unbound unless Bound_halos>=1 (substructure candidates are always
    # unbound inside the recursion, search.cxx:702); the bench sets
    # Bound_halos=1 explicitly since its metric includes the unbind stage
    iBoundHalos: int = 0
    iInclusiveHalo: int = 0
    iKeepFOF: int = 0
    num3dfof: int = 0
    iLargerCellSearch: int = 0
    Neff: int = -1
    # zoom (HIGHRES): DM heavier than this is low-res interloper
    # (reference allvars.h:600, set at read time from the lightest DM mass)
    zoomlowmassdm: float = 0.0
    iScaleLengths: int = 0

    # halo core search
    iHaloCoreSearch: int = 0
    iAdaptiveCoreLinking: int = 0
    iPhaseCoreGrowth: int = 1
    maxnlevelcoresearch: int = 5
    halocorexfac: float = 0.5
    halocorevfac: float = 2.0
    halocorenfac: float = 0.1
    halocoresigmafac: float = 2.0
    halocorenumloops: int = 3
    halocorexfaciter: float = 0.75
    halocorevfaciter: float = 0.75
    halocorenumfaciter: float = 1.0
    halocorephasedistsig: float = 2.0
    coresubmergemindist: float = 0.0

    # spherical overdensity
    SphericalOverdensitySeachFac: float = 2.5
    SphericalOverdensityMinHaloFac: float = 0.05

    # apertures / profiles / SO lists
    iaperturecalc: int = 0
    aperturenum: int = 0
    apertureprojnum: int = 0
    aperture_values_kpc: List[float] = field(default_factory=list)
    aperture_proj_values_kpc: List[float] = field(default_factory=list)
    iprofilecalc: int = 0
    iprofilenorm: int = PROFILERNORMR200CRIT
    iprofilebintype: int = PROFILERBINTYPELOG
    iprofilecumulative: int = 0
    profilenbins: int = 0
    profile_bin_edges: List[float] = field(default_factory=list)
    SOnum: int = 0
    SOthresholds_values_crit: List[float] = field(default_factory=list)

    # MPI-era knobs kept for config compatibility (mapped onto host-side
    # read/scatter buffer sizes in the TPU build)
    mpiparticletotbufsize: int = -1
    mpiparticlebufsize: int = -1
    mpipartfac: float = 0.1
    iopenmpfof: int = 1
    openmpfofsize: int = 2000000

    # nested structs
    uinfo: UnbindInfo = field(default_factory=UnbindInfo)
    pinfo: PropInfo = field(default_factory=PropInfo)

    # internal: unrecognised keywords seen during parsing
    unknown_keys: List[str] = field(default_factory=list)

    def copy(self) -> "Options":
        return dataclasses.replace(
            self,
            uinfo=dataclasses.replace(self.uinfo),
            pinfo=dataclasses.replace(self.pinfo),
            aperture_values_kpc=list(self.aperture_values_kpc),
            aperture_proj_values_kpc=list(self.aperture_proj_values_kpc),
            profile_bin_edges=list(self.profile_bin_edges),
            SOthresholds_values_crit=list(self.SOthresholds_values_crit),
            unknown_keys=list(self.unknown_keys),
        )


def _apply_keyword(opt: Options, key: str, val: str) -> bool:
    """Apply one config keyword.  Returns False if the keyword is unknown.

    Keyword set and field mapping follow reference ui.cxx:295-750 verbatim.
    """
    i, f, fl = _atoi, _atof, _floatlist
    u = opt.uinfo

    simple = {
        # search configuration (ui.cxx:380-404)
        "Particle_search_type": lambda v: setattr(opt, "partsearchtype", i(v)),
        "FoF_search_type": lambda v: setattr(opt, "foftype", i(v)),
        "FoF_Field_search_type": lambda v: setattr(opt, "fofbgtype", i(v)),
        "Search_for_substructure": lambda v: setattr(opt, "iSubSearch", i(v)),
        "Keep_FOF": lambda v: setattr(opt, "iKeepFOF", i(v)),
        "Iterative_searchflag": lambda v: setattr(opt, "iiterflag", i(v)),
        "Baryon_searchflag": lambda v: setattr(opt, "iBaryonSearch", i(v)),
        "CMrefadjustsubsearch_flag": lambda v: setattr(opt, "icmrefadjust", i(v)),
        "Halo_core_search": lambda v: setattr(opt, "iHaloCoreSearch", i(v)),
        "Use_adaptive_core_search": lambda v: setattr(opt, "iAdaptiveCoreLinking", int(f(v))),
        "Use_phase_tensor_core_growth": lambda v: setattr(opt, "iPhaseCoreGrowth", int(f(v))),
        # bg / fof parameters
        "Local_velocity_density_approximate_calculation": lambda v: setattr(opt, "iLocalVelDenApproxCalcFlag", i(v)),
        "Cell_fraction": lambda v: setattr(opt, "Ncellfac", f(v)),
        "Grid_type": lambda v: setattr(opt, "gridtype", i(v)),
        "Nsearch_velocity": lambda v: setattr(opt, "Nvel", i(v)),
        "Nsearch_physical": lambda v: setattr(opt, "Nsearch", i(v)),
        "Outlier_threshold": lambda v: setattr(opt, "ellthreshold", f(v)),
        "Significance_level": lambda v: setattr(opt, "siglevel", f(v)),
        "Velocity_ratio": lambda v: setattr(opt, "Vratio", f(v)),
        "Velocity_opening_angle": lambda v: setattr(opt, "thetaopen", f(v)),
        "Substructure_physical_linking_length": lambda v: setattr(opt, "ellphys", f(v)),
        "Physical_linking_length": lambda v: setattr(opt, "ellphys", f(v)),
        "Velocity_linking_length": lambda v: setattr(opt, "ellvel", f(v)),
        "Minimum_size": lambda v: setattr(opt, "MinSize", i(v)),
        "Minimum_halo_size": lambda v: setattr(opt, "HaloMinSize", i(v)),
        "Halo_linking_length_factor": lambda v: setattr(opt, "ellhalophysfac", f(v)),
        "Halo_3D_linking_length": lambda v: setattr(opt, "ellhalo3dxfac", f(v)),
        "Halo_velocity_linking_length_factor": lambda v: setattr(opt, "ellhalovelfac", f(v)),
        "Halo_6D_linking_length_factor": lambda v: setattr(opt, "ellhalo6dxfac", f(v)),
        "Halo_6D_vel_linking_length_factor": lambda v: setattr(opt, "ellhalo6dvfac", f(v)),
        # halo core search parameters
        "Halo_core_ellx_fac": lambda v: setattr(opt, "halocorexfac", f(v)),
        "Halo_core_ellv_fac": lambda v: setattr(opt, "halocorevfac", f(v)),
        "Halo_core_ncellfac": lambda v: setattr(opt, "halocorenfac", f(v)),
        "Halo_core_adaptive_sigma_fac": lambda v: setattr(opt, "halocoresigmafac", f(v)),
        "Halo_core_num_loops": lambda v: setattr(opt, "halocorenumloops", i(v)),
        "Halo_core_loop_ellx_fac": lambda v: setattr(opt, "halocorexfaciter", f(v)),
        "Halo_core_loop_ellv_fac": lambda v: setattr(opt, "halocorevfaciter", f(v)),
        "Halo_core_loop_elln_fac": lambda v: setattr(opt, "halocorenumfaciter", f(v)),
        "Halo_core_phase_significance": lambda v: setattr(opt, "halocorephasedistsig", f(v)),
        "Halo_core_phase_merge_dist": lambda v: setattr(opt, "coresubmergemindist", f(v)),
        # iterative search factors
        "Iterative_threshold_factor": lambda v: setattr(opt, "ellfac", f(v)),
        "Iterative_linking_length_factor": lambda v: setattr(opt, "ellxfac", f(v)),
        "Iterative_Vratio_factor": lambda v: setattr(opt, "vfac", f(v)),
        "Iterative_ThetaOp_factor": lambda v: setattr(opt, "thetafac", f(v)),
        "Effective_resolution": lambda v: setattr(opt, "Neff", i(v)),
        "Singlehalo_search": lambda v: setattr(opt, "iSingleHalo", i(v)),
        # units
        "Length_unit": lambda v: setattr(opt, "lengthinputconversion", f(v)),
        "Velocity_unit": lambda v: setattr(opt, "velocityinputconversion", f(v)),
        "Mass_unit": lambda v: setattr(opt, "massinputconversion", f(v)),
        "Hubble_unit": lambda v: setattr(opt, "H", f(v)),
        "Gravity": lambda v: setattr(opt, "G", f(v)),
        "Mass_value": lambda v: setattr(opt, "MassValue", f(v)),
        "Period": lambda v: setattr(opt, "p", f(v)),
        "Scale_factor": lambda v: setattr(opt, "a", f(v)),
        # cosmology
        "h_val": lambda v: setattr(opt, "h", f(v)),
        "Critical_density": lambda v: setattr(opt, "rhocrit", f(v)),
        "Virial_density": lambda v: setattr(opt, "virlevel", f(v)),
        "Omega_m": lambda v: setattr(opt, "Omega_m", f(v)),
        "Omega_Lambda": lambda v: setattr(opt, "Omega_Lambda", f(v)),
        "Omega_DE": lambda v: setattr(opt, "Omega_de", f(v)),
        "Omega_cdm": lambda v: setattr(opt, "Omega_cdm", f(v)),
        "Omega_b": lambda v: setattr(opt, "Omega_b", f(v)),
        "Omega_r": lambda v: setattr(opt, "Omega_r", f(v)),
        "Omega_nu": lambda v: setattr(opt, "Omega_nu", f(v)),
        "w_of_DE": lambda v: setattr(opt, "w_de", f(v)),
        # unit conversions
        "Length_input_unit_conversion_to_output_unit": lambda v: setattr(opt, "lengthinputconversion", f(v)),
        "Velocity_input_unit_conversion_to_output_unit": lambda v: setattr(opt, "velocityinputconversion", f(v)),
        "Mass_input_unit_conversion_to_output_unit": lambda v: setattr(opt, "massinputconversion", f(v)),
        "Metallicity_input_unit_conversion_to_output_unit": lambda v: setattr(opt, "metallicityinputconversion", f(v)),
        "Star_formation_rate_input_unit_conversion_to_output_unit": lambda v: setattr(opt, "SFRinputconversion", f(v)),
        "Stellar_age_input_unit_conversion_to_output_unit": lambda v: setattr(opt, "stellarageinputconversion", f(v)),
        "Stellar_age_input_is_cosmological_scalefactor": lambda v: setattr(opt, "istellaragescalefactor", i(v)),
        "Star_formation_rate_input_is_specific_star_formation_rate": lambda v: setattr(opt, "isfrisssfr", i(v)),
        "Length_unit_to_kpc": lambda v: setattr(opt, "lengthtokpc", f(v)),
        "Velocity_to_kms": lambda v: setattr(opt, "velocitytokms", f(v)),
        "Mass_to_solarmass": lambda v: setattr(opt, "masstosolarmass", f(v)),
        "Metallicity_to_solarmetallicity": lambda v: setattr(opt, "metallicitytosolar", f(v)),
        "Star_formation_rate_to_solarmassperyear": lambda v: setattr(opt, "SFRtosolarmassperyear", f(v)),
        "Stellar_age_to_yr": lambda v: setattr(opt, "stellaragetoyrs", f(v)),
        # unbinding
        "Unbind_flag": lambda v: setattr(u, "unbindflag", i(v)),
        "Unbinding_type": lambda v: setattr(u, "unbindtype", i(v)),
        "Bound_halos": lambda v: setattr(opt, "iBoundHalos", i(v)),
        "Allowed_kinetic_potential_ratio": lambda v: setattr(u, "Eratio", f(v)),
        "Min_bound_mass_frac": lambda v: setattr(u, "minEfrac", f(v)),
        "Keep_background_potential": lambda v: setattr(u, "bgpot", i(v)),
        "Kinetic_reference_frame_type": lambda v: setattr(u, "cmvelreftype", i(v)),
        "Min_npot_ref": lambda v: setattr(u, "Npotref", i(v)),
        "Frac_pot_ref": lambda v: setattr(u, "fracpotref", f(v)),
        "Unbinding_max_unbound_removal_fraction_per_iteration": lambda v: setattr(u, "maxunbindfrac", f(v)),
        "Unbinding_max_unbound_fraction": lambda v: setattr(u, "maxunboundfracforiterativeunbind", f(v)),
        "Unbinding_max_unbound_fraction_allowed": lambda v: setattr(u, "maxallowedunboundfrac", f(v)),
        "Softening_length": lambda v: setattr(u, "eps", f(v)),
        # properties
        "Reference_frame_for_properties": lambda v: setattr(opt, "iPropertyReferencePosition", i(v)),
        "Particle_type_for_reference_frames": lambda v: setattr(opt, "ParticleTypeForRefenceFrame", i(v)),
        "Iterate_cm_flag": lambda v: setattr(opt, "iIterateCM", i(v)),
        "Inclusive_halo_masses": lambda v: setattr(opt, "iInclusiveHalo", i(v)),
        "Extensive_halo_properties_output": lambda v: setattr(opt, "iextrahalooutput", i(v)),
        "Extensive_gas_properties_output": lambda v: setattr(opt, "iextragasoutput", i(v)),
        "Extensive_star_properties_output": lambda v: setattr(opt, "iextrastaroutput", i(v)),
        "Extensive_interloper_properties_output": lambda v: setattr(opt, "iextrainterloperoutput", i(v)),
        # apertures
        "Calculate_aperture_quantities": lambda v: setattr(opt, "iaperturecalc", i(v)),
        "Number_of_apertures": lambda v: setattr(opt, "aperturenum", i(v)),
        "Aperture_values_in_kpc": lambda v: setattr(opt, "aperture_values_kpc", fl(v)),
        "Number_of_projected_apertures": lambda v: setattr(opt, "apertureprojnum", i(v)),
        "Projected_aperture_values_in_kpc": lambda v: setattr(opt, "aperture_proj_values_kpc", fl(v)),
        # radial profiles
        "Calculate_radial_profiles": lambda v: setattr(opt, "iprofilecalc", i(v)),
        "Number_of_radial_profile_bin_edges": lambda v: setattr(opt, "profilenbins", i(v)),
        "Radial_profile_norm": lambda v: setattr(opt, "iprofilenorm", i(v)),
        "Radial_profile_bin_edges": lambda v: setattr(opt, "profile_bin_edges", fl(v)),
        # spherical overdensities
        "Number_of_overdensities": lambda v: setattr(opt, "SOnum", i(v)),
        "Overdensity_values_in_critical_density": lambda v: setattr(opt, "SOthresholds_values_crit", fl(v)),
        # other
        "Verbose": lambda v: setattr(opt, "iverbose", i(v)),
        "Write_group_array_file": lambda v: setattr(opt, "iwritefof", i(v)),
        "Snapshot_value": lambda v: setattr(opt, "snapshotvalue", i(v)),
        "Cosmological_input": lambda v: setattr(opt, "icosmologicalin", i(v)),
        "Input_chunk_size": lambda v: setattr(opt, "inputbufsize", i(v)),
        "MPI_particle_total_buf_size": lambda v: setattr(opt, "mpiparticletotbufsize", i(v)),
        "MPI_part_allocation_fac": lambda v: setattr(opt, "mpipartfac", f(v)),
        "OMP_run_fof": lambda v: setattr(opt, "iopenmpfof", i(v)),
        "OMP_fof_region_size": lambda v: setattr(opt, "openmpfofsize", i(v)),
        "Separate_output_files": lambda v: setattr(opt, "iseparatefiles", i(v)),
        "Binary_output": lambda v: setattr(opt, "ibinaryout", i(v)),
        "Comoving_units": lambda v: setattr(opt, "icomoveunit", i(v)),
        "Extended_output": lambda v: setattr(opt, "iextendedoutput", i(v)),
        "Spherical_overdensity_halo_particle_list_output": lambda v: setattr(opt, "iSphericalOverdensityPartList", i(v)),
        "Sort_by_binding_energy": lambda v: setattr(opt, "iSortByBindingEnergy", i(v)),
        "Velocity_scale_reference_bug_compat": lambda v: setattr(opt, "iVscaleReferenceBugCompat", i(v)),
        "Halo_local_density": lambda v: setattr(opt, "iHaloLocalDensity", i(v)),
        "SUBFIND_like_output": lambda v: setattr(opt, "isubfindoutput", i(v)),
        "NSPH_extra_blocks": lambda v: setattr(opt, "gnsphblocks", i(v)),
        "NStar_extra_blocks": lambda v: setattr(opt, "gnstarblocks", i(v)),
        "NBH_extra_blocks": lambda v: setattr(opt, "gnbhblocks", i(v)),
        # HDF input flags
        "HDF_name_convention": lambda v: setattr(opt, "ihdfnameconvention", i(v)),
        "Input_includes_dm_particle": lambda v: setattr(opt, "iusedmparticles", i(v)),
        "Input_includes_gas_particle": lambda v: setattr(opt, "iusegasparticles", i(v)),
        "Input_includes_star_particle": lambda v: setattr(opt, "iusestarparticles", i(v)),
        "Input_includes_bh_particle": lambda v: setattr(opt, "iusesinkparticles", i(v)),
        "Input_includes_wind_particle": lambda v: setattr(opt, "iusewindparticles", i(v)),
        "Input_includes_tracer_particle": lambda v: setattr(opt, "iusetracerparticles", i(v)),
        "Input_includes_extradm_particle": lambda v: setattr(opt, "iuseextradarkparticles", i(v)),
    }

    if key == "Output":
        opt.outname = val
        return True
    if key == "Output_den":
        # reference derives the cache name from outname (ui.cxx:377-380)
        opt.smname = f"{opt.outname}.localden" if opt.outname else val
        return True
    fn = simple.get(key)
    if fn is None:
        return False
    fn(val)
    return True


def parse_config_file(path: str, opt: Optional[Options] = None) -> Options:
    """Parse a reference-format ``key=value`` config file into ``Options``.

    Mirrors ui.cxx ``GetParamFile``: '#'-prefixed and empty lines skipped,
    key and value taken as the first whitespace token on each side of '='.
    """
    if opt is None:
        opt = Options()
    if not os.path.exists(path):
        raise FileNotFoundError(f"Config file: {path} does not exist or can't be read")
    opt.pname = path
    lines = []
    with open(path, "r") as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            pos = line.find("=")
            if pos <= 0:
                continue
            tag = line[:pos].split()
            valtoks = line[pos + 1:].split()
            if not tag or not valtoks:
                continue
            lines.append((tag[0], valtoks[0]))
    # first pass: find Output (the reference scans for it before anything else)
    for key, val in lines:
        if key == "Output":
            opt.outname = val
            break
    for key, val in lines:
        if not _apply_keyword(opt, key, val):
            opt.unknown_keys.append(key)
    return opt


def parse_config_string(text: str, opt: Optional[Options] = None) -> Options:
    """Parse config content given as a string (library-mode convenience)."""
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".cfg", delete=False) as fh:
        fh.write(text)
        tmp = fh.name
    try:
        return parse_config_file(tmp, opt)
    finally:
        os.unlink(tmp)


def config_check(opt: Options, strict: bool = False) -> Options:
    """Cross-validate and derive options; mirrors ui.cxx ``ConfigCheck``:751.

    ``strict``: enforce the reference's CLI-run requirements (unit
    conversions set, HDF naming convention chosen, baryon-search mode
    consistency) — the CLI passes True; library/test callers that build
    Options directly stay lenient.
    """
    if strict:
        if opt.inputtype == IOHDF and opt.ihdfnameconvention == -1:
            raise ValueError(
                "HDF input but HDF_name_convention not set (ui.cxx:760)")
        if opt.iBaryonSearch and opt.partsearchtype not in (PSTALL,
                                                           PSTDARK):
            raise ValueError(
                "Baryon_searchflag requires Particle_search_type all/dark "
                "(ui.cxx:764)")
        if opt.num_files < 1:
            raise ValueError("Invalid number of input files (<1)")
        for name, val in (("Length_unit_to_kpc", opt.lengthtokpc),
                          ("Velocity_to_kms", opt.velocitytokms),
                          ("Mass_to_solarmass", opt.masstosolarmass)):
            if val <= 0:
                raise ValueError(
                    f"Invalid unit conversion: {name} is <=0 or unset "
                    "(ui.cxx:785-800)")
    # Bound field objects are incompatible with keeping never-unbound
    # 3DFOF envelopes (reference errors, ui.cxx:768); the repo default is
    # iBoundHalos=1, so auto-clear instead of erroring on iKeepFOF runs
    if opt.iBoundHalos and opt.iKeepFOF:
        opt.iBoundHalos = 0
    if opt.iSubSearch:
        # substructure search requires local velocity density (STRUCDEN)
        pass
    if opt.HaloMinSize == -1:
        opt.HaloMinSize = opt.MinSize
    # 3DFOF halo linking length override (search.cxx uses
    # ellhalophysfac * ellphys; Halo_3D_linking_length sets the product)
    if opt.ellhalo3dxfac > 0:
        opt.ellhalophysfac = opt.ellhalo3dxfac / opt.ellphys
    if opt.iSingleHalo and opt.icosmologicalin:
        opt.icosmologicalin = 0
    # unbinding must be on to sort by binding energy meaningfully
    if opt.uinfo.unbindflag:
        opt.uinfo.icalculatepotential = True
    # aperture list consistency (reference exits on mismatch)
    if opt.iaperturecalc and opt.aperturenum != len(opt.aperture_values_kpc):
        raise ValueError(
            f"Number_of_apertures ({opt.aperturenum}) does not match "
            f"length of Aperture_values_in_kpc ({len(opt.aperture_values_kpc)})")
    if opt.iaperturecalc and opt.apertureprojnum != len(opt.aperture_proj_values_kpc):
        raise ValueError("projected aperture count mismatch")
    if opt.SOnum and opt.SOnum != len(opt.SOthresholds_values_crit):
        raise ValueError(
            f"Number_of_overdensities ({opt.SOnum}) does not match "
            f"length of Overdensity_values_in_critical_density "
            f"({len(opt.SOthresholds_values_crit)})")
    if opt.iprofilecalc and opt.profilenbins != len(opt.profile_bin_edges):
        raise ValueError("radial profile bin edge count mismatch")
    # sort aperture/SO lists ascending like the reference
    opt.aperture_values_kpc = sorted(opt.aperture_values_kpc)
    opt.aperture_proj_values_kpc = sorted(opt.aperture_proj_values_kpc)
    opt.SOthresholds_values_crit = sorted(opt.SOthresholds_values_crit)
    return opt
