"""Typed error hierarchy (reference: src/errors.rs:12-110).

Every variant of the reference's ``SpartanError`` enum maps to a
subclass here so callers can catch specific failures; all inherit
``SpartanError`` so blanket handling keeps working.  Variants that
carry a ``reason`` string in Rust take it as the exception message.
"""


class SpartanError(Exception):
    """Any proving/verification failure (errors.rs SpartanError)."""


class InvalidIndexError(SpartanError):
    """(row, col, val) tuple out of range (errors.rs InvalidIndex)."""


class InvalidStepCircuitIOError(SpartanError):
    """Step circuit used inputize/alloc_io instead of returning outputs
    (errors.rs InvalidStepCircuitIO)."""


class InvalidInputLengthError(SpartanError):
    """Supplied input has the wrong length (errors.rs InvalidInputLength)."""


class InvalidWitnessLengthError(SpartanError):
    """Supplied witness has the wrong length (errors.rs InvalidWitnessLength)."""


class UnSatError(SpartanError):
    """R1CS instance-witness pair does not satisfy the shape
    (errors.rs UnSat)."""


class ProofVerifyError(SpartanError):
    """Proof failed verification (errors.rs ProofVerifyError)."""


class InvalidCommitmentKeyLengthError(SpartanError):
    """Commitment key too short (errors.rs InvalidCommitmentKeyLength)."""


class InvalidCommitmentLengthError(SpartanError):
    """Commitment has the wrong length (errors.rs InvalidCommitmentLength)."""


class InvalidPCSError(SpartanError):
    """Invalid PCS evaluation argument (errors.rs InvalidPCS)."""


class InvalidSumcheckProofError(SpartanError):
    """Invalid sum-check proof (errors.rs InvalidSumcheckProof)."""


class InvalidInitialInputLengthError(SpartanError):
    """Initial input differs from declared arity
    (errors.rs InvalidInitialInputLength)."""


class InvalidStepOutputLengthError(SpartanError):
    """Step output differs from declared arity
    (errors.rs InvalidStepOutputLength)."""


class InternalTranscriptError(SpartanError):
    """Transcript round counter overflow (errors.rs InternalTranscriptError)."""


class InvalidMultisetProofError(SpartanError):
    """Multiset check failed (errors.rs InvalidMultisetProof)."""


class InvalidProductProofError(SpartanError):
    """Product proof check failed (errors.rs InvalidProductProof)."""


class IncorrectWitnessError(SpartanError):
    """Witness inconsistent with public IO (errors.rs IncorrectWitness)."""


class SynthesisError(SpartanError):
    """Circuit synthesis failure (errors.rs SynthesisError)."""


class DigestError(SpartanError):
    """Digest computation failure (errors.rs DigestError)."""


class InternalError(SpartanError):
    """Completeness failure inside the prover (errors.rs InternalError)."""


class DivisionByZeroError(SpartanError):
    """Division by zero (errors.rs DivisionByZero)."""


class InvalidVectorSizeError(SpartanError):
    """Input vector exceeds commitment key capacity
    (errors.rs InvalidVectorSize)."""

    def __init__(self, actual: int, max: int):
        super().__init__(f"vector size {actual} exceeds maximum {max}")
        self.actual = actual
        self.max = max
